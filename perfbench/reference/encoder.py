"""The image encoder: torchvision's ResNet-50 without its pooling and
classifier (inference-mode batch norm), then DeepHumor's spatial head:
the global embedding is the mean of the 7 x 7 grid through a linear
layer and a batch norm, the spatial embedding each grid cell through the
same linear layer (no batch norm). f32, NCHW inside, NHWC images in."""

import torch
import torch.nn.functional as F

BLOCKS = (3, 4, 6, 3)


def batch_norm(p, x, eps=1e-5):
    """Inference-mode batch norm over the channels of an NCHW tensor, or
    the last axis of a 2-d one."""
    shape = (1, -1, 1, 1) if x.ndim == 4 else (1, -1)
    mean = p["running_mean"].reshape(shape)
    var = p["running_var"].reshape(shape)
    return ((x - mean) / torch.sqrt(var + eps) * p["weight"].reshape(shape)
            + p["bias"].reshape(shape))


def conv(p, x, stride=1):
    k = p["weight"].shape[-1]
    return F.conv2d(x, p["weight"], stride=stride, padding=k // 2)


def bottleneck(p, x, stride):
    out = torch.relu(batch_norm(p["bn1"], conv(p["conv1"], x)))
    out = torch.relu(batch_norm(p["bn2"], conv(p["conv2"], out, stride)))
    out = batch_norm(p["bn3"], conv(p["conv3"], out))
    if "downsample" in p:
        x = batch_norm(p["downsample"]["bn"],
                       conv(p["downsample"]["conv"], x, stride))
    return torch.relu(out + x)


def resnet50(p, images):
    """NHWC images ``[B, 224, 224, 3]`` -> features ``[B, 2048, 7, 7]``."""
    x = images.permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(p["bn1"], F.conv2d(
        x, p["conv1"]["weight"], stride=2, padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    for s, n in enumerate(BLOCKS):
        for b in range(n):
            x = bottleneck(p[f"layer{s + 1}"][b], x,
                           2 if s > 0 and b == 0 else 1)
    return x


def encode(enc, images):
    """NHWC images -> (global embedding ``[B, D]``, spatial embedding
    ``[B, 49, D]``)."""
    feats = resnet50(enc["resnet"], images)
    grid = feats.flatten(2).transpose(1, 2)  # row-major cells
    lin = enc["linear"]
    start = batch_norm(enc["bn"], grid.mean(1) @ lin["weight"].T
                       + lin["bias"])
    return start, grid @ lin["weight"].T + lin["bias"]
