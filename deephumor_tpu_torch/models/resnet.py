"""ResNet-50 feature trunk (inference only), NHWC at its interface.

Counterpart of deephumor_tpu/models/resnet.py: the truncated torchvision
ResNet-50 (no avgpool/fc) with inference-mode batch norm in the same
folded scale/shift form. Input and output are NHWC like the JAX trunk;
inside, the convolutions run on channels_last NCHW tensors. Convolutions
are plain ``F.conv2d`` (the JAX package leaves them to XLA too).
"""

import torch
import torch.nn.functional as F

from deephumor_tpu_torch.models.layers import batch_norm_init

__all__ = ["resnet50_init", "resnet50_features", "BLOCK_COUNTS",
           "STAGE_WIDTHS"]

BLOCK_COUNTS = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)
_EXPANSION = 4
_BN_EPS = 1e-5


def _conv_init(gen, kh, kw, cin, cout, device):
    """Kaiming-normal fan-out init; weight OIHW."""
    std = (2.0 / (kh * kw * cout)) ** 0.5
    return {"weight": torch.randn((cout, cin, kh, kw), generator=gen,
                                  device=device) * std}


def _conv(params, x, stride=1):
    w = params["weight"]
    return F.conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)


def _bn(params, x):
    # inference-mode BN folded to one scale and one shift per channel
    inv = torch.rsqrt(params["running_var"] + _BN_EPS) * params["weight"]
    shift = params["bias"] - params["running_mean"] * inv
    return x * inv[:, None, None] + shift[:, None, None]


def _bottleneck_init(gen, cin, width, stride, device):
    cout = width * _EXPANSION
    params = {
        "conv1": _conv_init(gen, 1, 1, cin, width, device),
        "bn1": batch_norm_init(width, device),
        "conv2": _conv_init(gen, 3, 3, width, width, device),
        "bn2": batch_norm_init(width, device),
        "conv3": _conv_init(gen, 1, 1, width, cout, device),
        "bn3": batch_norm_init(cout, device),
    }
    if stride != 1 or cin != cout:
        params["downsample"] = {
            "conv": _conv_init(gen, 1, 1, cin, cout, device),
            "bn": batch_norm_init(cout, device),
        }
    return params


def _bottleneck(params, x, stride):
    out = torch.relu(_bn(params["bn1"], _conv(params["conv1"], x)))
    out = torch.relu(_bn(params["bn2"], _conv(params["conv2"], out, stride)))
    out = _bn(params["bn3"], _conv(params["conv3"], out))
    identity = x
    if "downsample" in params:
        ds = params["downsample"]
        identity = _bn(ds["bn"], _conv(ds["conv"], x, stride))
    return torch.relu(out + identity)


def resnet50_init(gen, device="cpu"):
    """Random ResNet-50 trunk parameters (real weights come from a
    converted checkpoint)."""
    params = {"conv1": _conv_init(gen, 7, 7, 3, 64, device),
              "bn1": batch_norm_init(64, device)}
    cin = 64
    for s, (blocks, width) in enumerate(zip(BLOCK_COUNTS, STAGE_WIDTHS)):
        stage = []
        for b in range(blocks):
            stride = 2 if s > 0 and b == 0 else 1
            stage.append(_bottleneck_init(gen, cin, width, stride, device))
            cin = width * _EXPANSION
        params[f"layer{s + 1}"] = stage
    return params


def resnet50_features(params, x):
    """``[bs, H, W, 3]`` NHWC images -> ``[bs, H/32, W/32, 2048]`` NHWC
    features (``[bs, 7, 7, 2048]`` at 224 x 224)."""
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    out = F.conv2d(x, params["conv1"]["weight"], stride=2, padding=3)
    out = torch.relu(_bn(params["bn1"], out))
    out = F.max_pool2d(out, kernel_size=3, stride=2, padding=1)
    for s, blocks in enumerate(BLOCK_COUNTS):
        stage = params[f"layer{s + 1}"]
        for b in range(blocks):
            out = _bottleneck(stage[b], out, 2 if s > 0 and b == 0 else 1)
    return out.permute(0, 2, 3, 1)
