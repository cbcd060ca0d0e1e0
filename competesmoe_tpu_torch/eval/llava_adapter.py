"""LLaVA model adapter: the part of competesmoe_tpu/eval/llava_adapter.py
the serving worker uses (model, tokenizer, image processor, prompt
tokenization, stop ids). The lmms evaluation interface waits."""

from __future__ import annotations

from typing import List, Optional

from ..models.llava import LlavaModel
from ..multimodal.mm_utils import ImageProcessorConfig, tokenizer_image_token


class TorchLlava:
    def __init__(self, model: LlavaModel, tokenizer,
                 image_processor: Optional[ImageProcessorConfig] = None,
                 conv_template: str = "phi35", batch_size: int = 1,
                 max_new_tokens: int = 128,
                 stop_token_ids: Optional[List[int]] = None,
                 speculative: int = 0):
        """speculative=K: generation verifies K prompt-lookup drafts per
        forward (B == 1), as JAX's adapter does."""
        self.model = model
        self.speculative = speculative
        self.tokenizer = tokenizer
        self.image_processor = image_processor or ImageProcessorConfig(
            size=model.cfg.vision.image_size)
        self.conv_template = conv_template
        self.batch_size = batch_size
        self.max_new_tokens = max_new_tokens
        self.stop_token_ids = stop_token_ids or []

    def tokenizer_ids_for_prompt(self, prompt: str,
                                 has_image: bool) -> List[int]:
        """Tokenize an already-templated prompt (serve worker path)."""
        if has_image:
            return tokenizer_image_token(prompt, self.tokenizer)
        return list(self.tokenizer(prompt).input_ids)
