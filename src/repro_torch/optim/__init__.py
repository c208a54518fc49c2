"""AdamW with fp32 master weights and its learning-rate schedules."""
from repro_torch.optim.adamw import (adamw_init, adamw_update,  # noqa: F401
                                     cast_like, global_norm)
from repro_torch.optim.schedules import lr_at  # noqa: F401
