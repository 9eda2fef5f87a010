"""Models of the port (inference)."""

from deephumor_tpu_torch.models.caption_models import CaptioningTransformer

__all__ = ["CaptioningTransformer"]
