"""Model code of the port: layers, compute backends, the decoder LM."""
from repro_torch.models.transformer import LM  # noqa: F401
