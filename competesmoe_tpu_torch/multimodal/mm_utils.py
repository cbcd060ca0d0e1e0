"""Image preprocessing and prompt tokenization (port of the serving part
of competesmoe_tpu/multimodal/mm_utils.py). PIL is imported inside the
functions that need it. Images come out as numpy NHWC, the layout the
vision tower takes."""

from __future__ import annotations

import base64
import dataclasses
from io import BytesIO
from typing import List, Sequence, Tuple

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


def process_images(images: Sequence, image_processor: ImageProcessorConfig
                   ) -> np.ndarray:
    """Batch preprocessing -> [B, H, W, 3] (the default resize path; the
    'pad' and 'anyres' aspect modes wait)."""
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
