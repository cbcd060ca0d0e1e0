"""Image preprocessing and prompt tokenization (port of
competesmoe_tpu/multimodal/mm_utils.py): the default resize, the 'pad'
mode (expand to a square on the mean colour) and the 'anyres' mode (the
best grid of the pinpoints, padded, cut into tiles after a resized base
image). PIL is imported inside the functions that need it. Images come
out as numpy NHWC, the layout the vision tower takes."""

from __future__ import annotations

import ast
import base64
import dataclasses
import math
from io import BytesIO
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..constants import IMAGE_TOKEN_INDEX


@dataclasses.dataclass(frozen=True)
class ImageProcessorConfig:
    """Minimal SigLIP image processor (resize -> rescale -> normalize).
    Defaults = google/siglip-so400m-patch14-224."""

    size: int = 224
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    resample: int = 3  # PIL.Image.BICUBIC

    @property
    def crop_size(self):
        return {"height": self.size, "width": self.size}

    def preprocess(self, image) -> np.ndarray:
        """PIL image -> [H, W, 3] float32 normalized."""
        img = image.convert("RGB").resize((self.size, self.size),
                                          self.resample)
        arr = np.asarray(img, np.float32) / 255.0
        mean = np.asarray(self.image_mean, np.float32)
        std = np.asarray(self.image_std, np.float32)
        return (arr - mean) / std


def load_image_from_base64(image: str):
    from PIL import Image
    return Image.open(BytesIO(base64.b64decode(image)))


def expand2square(pil_img, background_color):
    """Pad to a square on `background_color`, the image centred."""
    from PIL import Image
    width, height = pil_img.size
    if width == height:
        return pil_img
    if width > height:
        result = Image.new(pil_img.mode, (width, width), background_color)
        result.paste(pil_img, (0, (width - height) // 2))
        return result
    result = Image.new(pil_img.mode, (height, height), background_color)
    result.paste(pil_img, ((height - width) // 2, 0))
    return result


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions) -> Tuple[int, int]:
    """The anyres grid with the largest effective resolution, then the
    least waste."""
    ow, oh = original_size
    best, best_eff, best_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def resize_and_pad_image(image, target: Tuple[int, int]):
    """Aspect-preserving resize, then centred on black."""
    from PIL import Image
    ow, oh = image.size
    tw, th = target
    sw, sh = tw / ow, th / oh
    if sw < sh:
        nw, nh = tw, min(math.ceil(oh * sw), th)
    else:
        nh, nw = th, min(math.ceil(ow * sh), tw)
    resized = image.resize((nw, nh))
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def divide_to_patches(image, patch_size: int) -> List:
    """Row-major crop grid."""
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size,
                                       i + patch_size)))
    return patches


def _pinpoints(grid_pinpoints):
    return (grid_pinpoints if isinstance(grid_pinpoints, list)
            else ast.literal_eval(grid_pinpoints))


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size):
    w, h = select_best_resolution(image_size, _pinpoints(grid_pinpoints))
    return w // patch_size, h // patch_size


def process_anyres_image(image, processor: ImageProcessorConfig,
                         grid_pinpoints) -> np.ndarray:
    """[1 + n_tiles, H, W, 3]: the resized whole image, then the tiles of
    the best grid."""
    best = select_best_resolution(image.size, _pinpoints(grid_pinpoints))
    padded = resize_and_pad_image(image, best)
    patches = divide_to_patches(padded, processor.crop_size["height"])
    base = image.resize((processor.size, processor.size))
    return np.stack([processor.preprocess(p) for p in [base] + patches])


def process_images(images: Sequence, image_processor: ImageProcessorConfig,
                   image_aspect_ratio: Optional[str] = None,
                   image_grid_pinpoints=None):
    """Batch preprocessing -> [B, H, W, 3]; 'pad' squares each image on
    the processor's mean colour first; 'anyres' gives [B, 1 + tiles, H,
    W, 3] (a list when the images' tile counts differ)."""
    if image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in image_processor.image_mean)
        return np.stack([image_processor.preprocess(
            expand2square(im.convert("RGB"), bg)) for im in images])
    if image_aspect_ratio == "anyres":
        out = [process_anyres_image(im, image_processor,
                                    image_grid_pinpoints) for im in images]
        if all(x.shape == out[0].shape for x in out):
            return np.stack(out)
        return out
    return np.stack([image_processor.preprocess(im) for im in images])


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    """Tokenize around '<image>' and splice the image token id, keeping a
    single BOS."""
    prompt_chunks = [tokenizer(chunk).input_ids
                     for chunk in prompt.split("<image>")]

    def insert_separator(X, sep):
        return [e for pair in zip(X, [sep] * len(X)) for e in pair][:-1]

    input_ids: List[int] = []
    offset = 0
    bos = getattr(tokenizer, "bos_token_id", None)
    if prompt_chunks and prompt_chunks[0] and bos is not None \
            and prompt_chunks[0][0] == bos:
        offset = 1
        input_ids.append(prompt_chunks[0][0])
    for x in insert_separator(prompt_chunks,
                              [image_token_index] * (offset + 1)):
        input_ids.extend(x[offset:])
    return input_ids
