"""Sequence-chunked pipeline training (Seq1F1B / SlimPipe lineage; port
of ``repro/seqpipe``).

Splits every microbatch along the sequence dimension into ``n_seq``
causally-ordered chunks and threads the fifth scheduling coordinate
(``Task.seq``) through the stack:

- :mod:`repro_torch.seqpipe.schedules` — the ``seq1f1b`` and
  ``chronos_seq`` generators (registered into
  ``repro_torch.core.schedules.REGISTRY``);
- :mod:`repro_torch.seqpipe.attention` — chunked causal attention over
  the flash kernel at a query offset, and ``merge_kv``;
- :mod:`repro_torch.seqpipe.runtime` — the executor's KV-carry and dKV
  rings.

Entry point: ``make_pipeline_spec(..., schedule="seq1f1b" |
"chronos_seq", n_seq=k)``; ``make_train_grads_fn`` runs the seq executor
when the table carries sequence chunks.
"""
from repro_torch.seqpipe.schedules import chronos_seq, seq1f1b  # noqa: F401
