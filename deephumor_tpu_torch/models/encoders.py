"""Image encoder (inference).

Counterpart of deephumor_tpu/models/encoders.py ``image_encoder_apply``
in eval mode: frozen ResNet-50 features; the global path is avgpool ->
shared linear -> batch norm; the spatial path is the 7x7 grid -> the same
shared linear with NO batch norm (a reference quirk the checkpoints bake
in). Dropout is the identity at inference.
"""

from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.models.resnet import (resnet50_features,
                                               resnet50_init)

__all__ = ["image_encoder_init", "image_encoder_apply",
           "RESNET_FEATURE_DIM"]

RESNET_FEATURE_DIM = 2048


def image_encoder_init(gen, emb_dim=256, device="cuda"):
    return {
        "resnet": resnet50_init(gen, device),
        "linear": L.linear_init(gen, RESNET_FEATURE_DIM, emb_dim, device),
        "bn": L.batch_norm_init(emb_dim, device),
    }


def image_encoder_apply(params, images, *, spatial_features=False):
    """NHWC images -> ``emb [bs, emb_dim]``, or ``(emb, spatial_emb
    [bs, 49, emb_dim])`` with ``spatial_features``."""
    feats = resnet50_features(params["resnet"], images)
    bs = feats.shape[0]
    emb = L.batch_norm(params["bn"],
                       L.linear(params["linear"], feats.mean(dim=(1, 2))))
    if not spatial_features:
        return emb
    # row-major h*W+w order, matching the reference's NCHW reshape
    grid = feats.reshape(bs, -1, RESNET_FEATURE_DIM)
    return emb, L.linear(params["linear"], grid)
