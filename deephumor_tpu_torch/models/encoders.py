"""Image, label and image+label encoders (inference).

Counterpart of deephumor_tpu/models/encoders.py in eval mode: frozen
ResNet-50 features; the global path is avgpool -> shared linear -> batch
norm; the spatial path is the 7x7 grid -> the same shared linear with NO
batch norm (a reference quirk the checkpoints bake in). The label encoder
mean-pools its token embedding; the image+label encoder joins the two and
projects them back to ``emb_dim``. Dropout is the identity at inference.
"""

import torch

from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.models.resnet import (resnet50_features,
                                               resnet50_init)

__all__ = ["image_encoder_init", "image_encoder_apply", "label_encoder_init",
           "label_encoder_apply", "image_label_encoder_init",
           "image_label_encoder_apply", "RESNET_FEATURE_DIM"]

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


def label_encoder_init(gen, num_tokens, emb_dim=256, device="cuda"):
    return {"embedding": L.embedding_init(gen, num_tokens, emb_dim, device)}


def label_encoder_apply(params, labels):
    """Mean-pooled label-token embedding ``[bs, emb_dim]`` of ``labels
    [bs, n]`` (pad tokens included, as in the reference)."""
    return L.embed(params["embedding"], labels).mean(dim=1)


def image_label_encoder_init(gen, num_tokens, emb_dim=256, device="cuda"):
    return {
        "image_encoder": image_encoder_init(gen, emb_dim, device),
        "label_encoder": label_encoder_init(gen, num_tokens, emb_dim, device),
        "linear": L.linear_init(gen, 2 * emb_dim, emb_dim, device),
    }


def image_label_encoder_apply(params, images, labels):
    """Joint image + label embedding ``[bs, emb_dim]``."""
    emb = torch.cat([image_encoder_apply(params["image_encoder"], images),
                     label_encoder_apply(params["label_encoder"], labels)],
                    dim=1)
    return L.linear(params["linear"], emb)
