"""Models of the port: the captioners, the encoders, beam search and
the reference-name layer handles (counterpart of deephumor_tpu/models)."""

from deephumor_tpu_torch.models.caption_models import (
    MODEL_REGISTRY, CaptioningLSTM, CaptioningLSTMWithLabels,
    CaptioningMLAMoE, CaptioningTransformer, CaptioningTransformerBase)
from deephumor_tpu_torch.models.compat import (
    ImageEncoder, ImageLabelEncoder, LabelEncoder, LSTMDecoder,
    SelfAttentionTransformerDecoder, TransformerDecoder, TransformerEncoder)
from deephumor_tpu_torch.models.encoders import (
    image_encoder_apply, image_encoder_init, image_label_encoder_apply,
    image_label_encoder_init, label_encoder_apply, label_encoder_init)
from deephumor_tpu_torch.models.sampling import beam_search, filter_top_k

__all__ = [
    "ImageEncoder", "LabelEncoder", "ImageLabelEncoder", "LSTMDecoder",
    "TransformerEncoder", "TransformerDecoder",
    "SelfAttentionTransformerDecoder",
    "MODEL_REGISTRY", "CaptioningLSTM", "CaptioningLSTMWithLabels",
    "CaptioningTransformer", "CaptioningTransformerBase",
    "CaptioningMLAMoE", "image_encoder_init", "image_encoder_apply",
    "label_encoder_init",
    "label_encoder_apply", "image_label_encoder_init",
    "image_label_encoder_apply", "beam_search", "filter_top_k",
]
