"""Image preprocessing.

Counterpart of deephumor_tpu/ops/image_ops.py. The reference transform is
a bilinear resize to 224 x 224, scaling to [0, 1] and ImageNet
normalisation. Two paths:

- :func:`preprocess_pil`: the host-side PIL resize, as the reference's
  torchvision transform does it (PIL is imported at the call: a machine
  without Pillow can still import this module);
- :func:`preprocess_batch`: the same on the tensor's device, for serving.
  ``jax.image.resize(..., "bilinear")`` antialiases when it downscales;
  ``F.interpolate(..., antialias=True)`` on NCHW gives the same filter.

Plain PyTorch ops, not a kernel: the JAX package leaves this step to XLA.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "preprocess_pil",
           "preprocess_batch"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_pil(img, size=(224, 224)):
    """PIL.Image -> normalised float32 numpy array ``[H, W, 3]`` (PIL
    bilinear resize)."""
    from PIL import Image

    img = img.convert("RGB").resize(size[::-1], Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def preprocess_batch(images_u8, size=(224, 224)):
    """uint8 NHWC batch ``[B, H, W, 3]`` -> resized, normalised float32
    NHWC ``[B, size[0], size[1], 3]`` on the batch's device."""
    x = torch.as_tensor(images_u8)
    x = x.to(torch.float32).div_(255.0).permute(0, 3, 1, 2)
    if tuple(x.shape[2:]) != tuple(size):
        x = F.interpolate(x, size=tuple(size), mode="bilinear",
                          align_corners=False, antialias=True)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return ((x.permute(0, 2, 3, 1) - mean) / std).contiguous()
