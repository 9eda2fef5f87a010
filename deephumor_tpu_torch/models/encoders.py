"""Image, label and image+label encoders.

Counterpart of deephumor_tpu/models/encoders.py: frozen ResNet-50
features; the global path is avgpool -> shared linear -> batch norm ->
dropout; the spatial path is the 7x7 grid -> the same shared linear ->
dropout, with NO batch norm (a reference quirk the checkpoints bake in).
The label encoder mean-pools its token embedding; the image+label encoder
joins the two and projects them back to ``emb_dim``.

Every apply function takes ``train`` and ``gen`` (the ``torch.Generator``
its dropout draws from); in train mode it returns ``(out, new_params)``
with the head's batch-norm statistics advanced. The ResNet trunk always
runs in eval mode without a gradient (it is frozen), so its features can
be computed once per template (:func:`image_encoder_trunk`) and passed
back with ``from_trunk=True``.
"""

import torch

from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.models.resnet import (resnet50_features,
                                               resnet50_init)

__all__ = ["image_encoder_init", "image_encoder_apply", "image_encoder_trunk",
           "label_encoder_init", "label_encoder_apply",
           "image_label_encoder_init", "image_label_encoder_apply",
           "RESNET_FEATURE_DIM"]

RESNET_FEATURE_DIM = 2048


def image_encoder_init(gen, emb_dim=256, device="cuda"):
    return {
        "resnet": resnet50_init(gen, device),
        "linear": L.linear_init(gen, RESNET_FEATURE_DIM, emb_dim, device),
        "bn": L.batch_norm_init(emb_dim, device),
    }


def image_encoder_trunk(params, images):
    """The frozen ResNet trunk alone: NHWC images -> ``[bs, 7, 7, 2048]``,
    computed without a gradient (the JAX package's ``stop_gradient``)."""
    with torch.no_grad():
        return resnet50_features(params["resnet"], images)


def image_encoder_apply(params, images, *, spatial_features=False,
                        dropout=0.2, train=False, gen=None, from_trunk=False,
                        group=None):
    """NHWC images (or, with ``from_trunk``, :func:`image_encoder_trunk`
    output) -> ``emb [bs, emb_dim]``, or ``(emb, spatial_emb [bs, 49,
    emb_dim])`` with ``spatial_features``; in train mode wrapped as
    ``(out, new_params)``, the batch norm's moments pooled over ``group``
    (a mesh's data axis; ``layers.batch_norm``)."""
    feats = images if from_trunk else image_encoder_trunk(params, images)
    bs = feats.shape[0]
    emb = L.linear(params["linear"], feats.mean(dim=(1, 2)))
    new_params = params
    if train:
        emb, new_bn = L.batch_norm(params["bn"], emb, train=True,
                                   group=group)
        new_params = dict(params, bn=new_bn)
        emb = L.dropout(gen, emb, dropout, True)
    else:
        emb = L.batch_norm(params["bn"], emb)
    out = emb
    if spatial_features:
        # row-major h*W+w order, matching the reference's NCHW reshape
        grid = feats.reshape(bs, -1, RESNET_FEATURE_DIM)
        out = (emb, L.dropout(gen, L.linear(params["linear"], grid), dropout,
                              train))
    return (out, new_params) if train else out


def label_encoder_init(gen, num_tokens, emb_dim=256, device="cuda"):
    return {"embedding": L.embedding_init(gen, num_tokens, emb_dim, device)}


def label_encoder_apply(params, labels, *, dropout=0.2, train=False,
                        gen=None):
    """Mean-pooled label-token embedding ``[bs, emb_dim]`` of ``labels
    [bs, n]`` (pad tokens included, as in the reference)."""
    emb = L.embed(params["embedding"], labels).mean(dim=1)
    return L.dropout(gen, emb, dropout, train)


def image_label_encoder_init(gen, num_tokens, emb_dim=256, device="cuda"):
    return {
        "image_encoder": image_encoder_init(gen, emb_dim, device),
        "label_encoder": label_encoder_init(gen, num_tokens, emb_dim, device),
        "linear": L.linear_init(gen, 2 * emb_dim, emb_dim, device),
    }


def image_label_encoder_apply(params, images, labels, *, dropout=0.2,
                              train=False, gen=None, from_trunk=False,
                              group=None):
    """Joint image + label embedding ``[bs, emb_dim]``; in train mode
    ``(emb, new_params)`` (``group`` as :func:`image_encoder_apply`)."""
    image_emb = image_encoder_apply(
        params["image_encoder"], images, dropout=dropout, train=train,
        gen=gen, from_trunk=from_trunk, group=group)
    new_params = params
    if train:
        image_emb, new_img = image_emb
        new_params = dict(params, image_encoder=new_img)
    label_emb = label_encoder_apply(params["label_encoder"], labels,
                                    dropout=dropout, train=train, gen=gen)
    emb = L.linear(params["linear"], torch.cat([image_emb, label_emb], dim=1))
    emb = L.dropout(gen, emb, dropout, train)
    return (emb, new_params) if train else emb
