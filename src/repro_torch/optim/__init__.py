"""AdamW with fp32 master weights, its learning-rate schedules, the
Chronos-Offload host optimizer of the deepest chunks, and the int8/int16
gradient compression with error feedback."""
from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: F401
                                     cast_like, global_norm)
from repro_torch.optim.compression import (compressed_sum,  # noqa: F401
                                           compressed_sum_over,
                                           dequantize_int8, ef_init,
                                           quantize_int8)
from repro_torch.optim.schedules import lr_at  # noqa: F401
from repro_torch.optim.offload import (ChronosOffloadRunner,  # noqa: F401
                                       HostAdamW, merge_deep_shallow,
                                       split_deep_shallow)
