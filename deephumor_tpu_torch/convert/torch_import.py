"""Reference PyTorch checkpoint -> the JAX package's parameter layout.

Counterpart of deephumor_tpu/convert/torch_import.py. It reads the
reference checkpoint contract, ``{'model': state_dict, 'hp': dict}`` saved
with ``torch.save``, for all four model classes, and gives the JAX layout
as numpy arrays; ``convert/jax_params.params_from_jax`` turns that into
the port's tree, so the port's layout mapping lives in one place.

Layout transforms:
- conv kernels OIHW -> HWIO,
- linear kernels [out, in] -> [in, out],
- embedding tables pass through,
- BN running stats map to {scale, bias, mean, var},
- LSTM weight_ih/hh_l{k} [4H, x] -> transposed, torch gate order kept,
- the reference's constant non-trainable ``scale`` params are dropped
  (recomputed from hyperparameters),
- ``num_batches_tracked`` counters are dropped.
"""

import numpy as np
import torch

from deephumor_tpu_torch.models.resnet import BLOCK_COUNTS

__all__ = [
    "load_torch_checkpoint",
    "convert_state_dict",
    "convert_resnet",
]


def _np(t):
    """torch tensor | ndarray -> float32/int numpy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _linear(sd, prefix):
    return {
        "kernel": _np(sd[f"{prefix}.weight"]).T.copy(),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def _bn(sd, prefix):
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
        "mean": _np(sd[f"{prefix}.running_mean"]),
        "var": _np(sd[f"{prefix}.running_var"]),
    }


def _conv(sd, key):
    # OIHW -> HWIO
    return {"kernel": _np(sd[key]).transpose(2, 3, 1, 0).copy()}


def _embedding(sd, key):
    return {"table": _np(sd[key])}


def _layer_norm(sd, prefix):
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
    }


def convert_resnet(sd, prefix):
    """Truncated-ResNet-50 ``nn.Sequential`` state dict -> pytree.

    The reference wraps ``children()[:-2]`` in a Sequential
    (encoders.py:37-38) so the child indices are: 0=conv1, 1=bn1, 2=relu,
    3=maxpool, 4..7=layer1..4 (torchvision naming inside each block).
    """
    params = {
        "conv1": _conv(sd, f"{prefix}.0.weight"),
        "bn1": _bn(sd, f"{prefix}.1"),
    }
    for s, blocks in enumerate(BLOCK_COUNTS):
        seq_idx = 4 + s
        stage = []
        for b in range(blocks):
            bp = f"{prefix}.{seq_idx}.{b}"
            block = {
                "conv1": _conv(sd, f"{bp}.conv1.weight"),
                "bn1": _bn(sd, f"{bp}.bn1"),
                "conv2": _conv(sd, f"{bp}.conv2.weight"),
                "bn2": _bn(sd, f"{bp}.bn2"),
                "conv3": _conv(sd, f"{bp}.conv3.weight"),
                "bn3": _bn(sd, f"{bp}.bn3"),
            }
            if f"{bp}.downsample.0.weight" in sd:
                block["downsample"] = {
                    "conv": _conv(sd, f"{bp}.downsample.0.weight"),
                    "bn": _bn(sd, f"{bp}.downsample.1"),
                }
            stage.append(block)
        params[f"layer{s + 1}"] = stage
    return params


def _convert_image_encoder(sd, prefix):
    return {
        "resnet": convert_resnet(sd, f"{prefix}.resnet"),
        "linear": _linear(sd, f"{prefix}.linear"),
        "bn": _bn(sd, f"{prefix}.bn"),
    }


def _convert_lstm(sd, prefix):
    layers = []
    k = 0
    while f"{prefix}.weight_ih_l{k}" in sd:
        layers.append(
            {
                "wi": _np(sd[f"{prefix}.weight_ih_l{k}"]).T.copy(),
                "wh": _np(sd[f"{prefix}.weight_hh_l{k}"]).T.copy(),
                "bi": _np(sd[f"{prefix}.bias_ih_l{k}"]),
                "bh": _np(sd[f"{prefix}.bias_hh_l{k}"]),
            }
        )
        k += 1
    return layers


def _convert_mha(sd, prefix):
    return {
        "fc_q": _linear(sd, f"{prefix}.fc_q"),
        "fc_k": _linear(sd, f"{prefix}.fc_k"),
        "fc_v": _linear(sd, f"{prefix}.fc_v"),
        "fc_o": _linear(sd, f"{prefix}.fc_o"),
    }


def _convert_transformer_decoder(sd, prefix):
    """Either transformer decoder variant (cross-attn detected per layer)."""
    layers = []
    i = 0
    while f"{prefix}.layers.{i}.self_attn.fc_q.weight" in sd:
        lp = f"{prefix}.layers.{i}"
        layer = {
            "self_attn": _convert_mha(sd, f"{lp}.self_attn"),
            "self_attn_ln": _layer_norm(sd, f"{lp}.self_attn_ln"),
            "pf": {
                "fc_1": _linear(sd, f"{lp}.pf.fc_1"),
                "fc_2": _linear(sd, f"{lp}.pf.fc_2"),
            },
            "pf_ln": _layer_norm(sd, f"{lp}.pf_ln"),
        }
        if f"{lp}.enc_attn.fc_q.weight" in sd:
            layer["enc_attn"] = _convert_mha(sd, f"{lp}.enc_attn")
            layer["enc_attn_ln"] = _layer_norm(sd, f"{lp}.enc_attn_ln")
        layers.append(layer)
        i += 1
    return {
        "tok_embedding": _embedding(sd, f"{prefix}.tok_embedding.weight"),
        "pos_embedding": _embedding(sd, f"{prefix}.pos_embedding.weight"),
        "layers": layers,
        "classifier": _linear(sd, f"{prefix}.classifier"),
    }


def convert_state_dict(sd, model_type):
    """Converts a reference state_dict to the JAX package's parameter
    layout (numpy leaves).

    Args:
        sd: flat torch state_dict (str -> tensor).
        model_type: one of ``captioning_lstm``, ``captioning_lstm_labels``,
            ``captioning_transformer_base``, ``captioning_transformer``.

    Returns:
        nested dict tree matching the JAX model's ``init``.
    """
    if model_type == "captioning_lstm":
        return {
            "encoder": _convert_image_encoder(sd, "encoder"),
            "decoder": {
                "embedding": _embedding(sd, "decoder.embedding.weight"),
                "lstm": _convert_lstm(sd, "decoder.lstm"),
                "classifier": _linear(sd, "decoder.classifier"),
            },
        }
    if model_type == "captioning_lstm_labels":
        # decoder embedding IS the label-encoder embedding in the reference
        # (caption_models.py:125); the pytree stores it once under the
        # encoder and the model wires it into the decoder at apply time.
        return {
            "encoder": {
                "image_encoder": _convert_image_encoder(
                    sd, "encoder.image_encoder"
                ),
                "label_encoder": {
                    "embedding": _embedding(
                        sd, "encoder.label_encoder.embedding.weight"
                    ),
                },
                "linear": _linear(sd, "encoder.linear"),
            },
            "decoder": {
                "lstm": _convert_lstm(sd, "decoder.lstm"),
                "classifier": _linear(sd, "decoder.classifier"),
            },
        }
    if model_type in ("captioning_transformer_base", "captioning_transformer"):
        return {
            "encoder": _convert_image_encoder(sd, "encoder"),
            "decoder": _convert_transformer_decoder(sd, "decoder"),
        }
    raise ValueError(f"unknown model_type: {model_type}")


def load_torch_checkpoint(ckpt_path, model_type):
    """Loads a reference ``.pth`` checkpoint.

    Returns:
        (JAX-layout params tree, hp dict): the reference's
        ``{'model', 'hp'}`` payload, converted.
    """
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    return convert_state_dict(ckpt["model"], model_type), ckpt["hp"]
