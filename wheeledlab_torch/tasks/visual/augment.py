"""Image augmentations of the visual policy's observation — the port of
`wheeledlab_tpu/tasks/visual/augment.py`, behavioural equivalents of the
reference's torchvision pipeline (visual/mdp_sensors/observations.py:75-87:
crop the top third, ColorJitter, GaussianBlur(5, sigma 0.1-5.0), grayscale,
(x - 0.5) / 0.5, flatten).

The renderer outputs grayscale, so brightness and contrast jitter and the
5-tap separable Gaussian blur are applied, per env. `augment_images` draws
the per-env factors from a generator; `augment_images_with` takes them."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...utils import math as wmath

BLUR_TAPS = 5


def _gauss_kernel5(sigma: torch.Tensor) -> torch.Tensor:
    """(..., 5) normalized 1-D Gaussian taps for per-env sigma."""
    x = (torch.arange(BLUR_TAPS, dtype=torch.float32, device=sigma.device)
         - (BLUR_TAPS - 1) / 2.0)
    k = torch.exp(-0.5 * (x / sigma[..., None]) ** 2)
    return k / k.sum(-1, keepdim=True)


def _sep_blur(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap blur of (B, H, W) with per-image (B, 5) taps, edge
    padded. The taps are summed in the reference's order, from 0 + k0 p0."""
    pad = BLUR_TAPS // 2
    h, w = img.shape[-2:]
    k = kernel[:, :, None, None]                      # (B, 5, 1, 1)
    padded = F.pad(img[:, None], (0, 0, pad, pad), mode="replicate")[:, 0]
    rows = 0
    for i in range(BLUR_TAPS):
        rows = rows + k[:, i] * padded[:, i:i + h, :]
    padded = F.pad(rows[:, None], (pad, pad, 0, 0), mode="replicate")[:, 0]
    out = 0
    for i in range(BLUR_TAPS):
        out = out + k[:, i] * padded[:, :, i:i + w]
    return out


def augmentation_draws(b: int, generator: torch.Generator, device,
                       brightness: float = 0.8, contrast: float = 0.2,
                       sigma_range=(0.1, 5.0)):
    """Per-env brightness and contrast factors and blur sigma, (b,) each,
    uniform in the reference's ranges."""
    def u(lo, hi):
        return (torch.rand((b,), generator=generator, device=device)
                * (hi - lo) + lo)

    return (u(max(0.0, 1 - brightness), 1 + brightness),
            u(max(0.0, 1 - contrast), 1 + contrast),
            u(*sigma_range))


def augment_images_with(images: torch.Tensor, bf: torch.Tensor,
                        cf: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """images (B, H, W) grayscale in [0, 1] -> augmented, same shape, with
    the given per-env factors."""
    img = torch.clamp(images * bf[:, None, None], 0.0, 1.0)
    mean = img.mean((1, 2), keepdim=True)
    img = torch.clamp(mean + cf[:, None, None] * (img - mean), 0.0, 1.0)
    return _sep_blur(img, _gauss_kernel5(sigma))


def augment_images(images: torch.Tensor, generator: torch.Generator,
                   brightness: float = 0.8, contrast: float = 0.2,
                   sigma_range=(0.1, 5.0)) -> torch.Tensor:
    """images (B, H, W) grayscale in [0, 1] -> augmented, same shape."""
    draws = augmentation_draws(images.shape[0], generator, images.device,
                               brightness, contrast, sigma_range)
    return augment_images_with(images, *draws)


def crop_gray_normalize_flatten(images: torch.Tensor) -> torch.Tensor:
    """Top-third crop, (x - 0.5) / 0.5, flatten: (B, H, W) ->
    (B, (H - H // 3) * W)."""
    h = images.shape[1]
    cropped = images[:, h // 3:, :]
    return wmath.div(cropped - 0.5, 0.5).reshape(images.shape[0], -1)
