"""Reference-name handles onto the functional layers.

Counterpart of deephumor_tpu/models/compat.py. The reference exports layer
classes from ``deephumor.models`` (ImageEncoder, LSTMDecoder,
TransformerDecoder, ...); the port's layers are functions over parameter
trees, and these classes carry the reference's names so that code written
against them finds working equivalents:

    params = ImageEncoder.init(gen, emb_dim=256, device="cuda")
    emb = ImageEncoder.apply(params, images)

Each attribute is the function itself (documented in its module); nothing
here adds behaviour.
"""

from deephumor_tpu_torch.models import encoders as _enc
from deephumor_tpu_torch.models import lstm as _lstm
from deephumor_tpu_torch.models import transformer as _tfm

__all__ = ["ImageEncoder", "LabelEncoder", "ImageLabelEncoder",
           "LSTMDecoder", "TransformerEncoder", "TransformerDecoder",
           "SelfAttentionTransformerDecoder"]


class ImageEncoder:
    """Frozen ResNet-50 + projection head."""

    init = staticmethod(_enc.image_encoder_init)
    apply = staticmethod(_enc.image_encoder_apply)
    trunk = staticmethod(_enc.image_encoder_trunk)


class LabelEncoder:
    """Mean-pooled label embedding."""

    init = staticmethod(_enc.label_encoder_init)
    apply = staticmethod(_enc.label_encoder_apply)


class ImageLabelEncoder:
    """Image + label fusion encoder."""

    init = staticmethod(_enc.image_label_encoder_init)
    apply = staticmethod(_enc.image_label_encoder_apply)


class LSTMDecoder:
    """Embedding -> stacked LSTM -> classifier."""

    init = staticmethod(_lstm.lstm_decoder_init)
    forward = staticmethod(_lstm.lstm_decoder_forward)
    step = staticmethod(_lstm.lstm_step)


class TransformerEncoder:
    """Post-LN encoder stack."""

    init = staticmethod(_tfm.transformer_encoder_init)
    forward = staticmethod(_tfm.transformer_encoder_forward)


class TransformerDecoder:
    """Cross-attention decoder."""

    init = staticmethod(_tfm.transformer_decoder_init)
    forward = staticmethod(_tfm.transformer_decoder_forward)
    decode_step = staticmethod(_tfm.decode_step)


class SelfAttentionTransformerDecoder:
    """Decoder-only variant."""

    init = staticmethod(_tfm.self_attn_decoder_init)
    forward = staticmethod(_tfm.self_attn_decoder_forward)
    decode_step = staticmethod(_tfm.decode_step)
