"""Multimodal supervised-finetuning data pipeline (port of
competesmoe_tpu/data/mm_data.py; numpy only, so the same records, tokenizer
and seed give the same tokens, labels, pixels and batch order as there).

The reference's data side, `moe_model/train/train.py`:
- `preprocess_phi35` conversation tokenization with assistant-only label
  masking (train.py:444-560 semantics, reproduced round-splitting exactly)
- `preprocess_plain` for the projector-pretrain stage (image + caption)
- `LazySupervisedDataset` over LLaVA-style conversation json + image dir
  (train.py:1071-1168)
- `SupervisedCollator` right-padding to the batch max (train.py:1170-1201)
- `LengthGroupedSampler` by modality (llava_trainer.py:140-232)
"""

from __future__ import annotations

import copy
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..constants import IGNORE_INDEX
from ..multimodal import conversation as conversation_lib
from ..multimodal.mm_utils import (
    ImageProcessorConfig,
    process_images,
    tokenizer_image_token,
)


def _apply_template(sources, conv):
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for source in sources:
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], "conversation roles must alternate"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def preprocess_phi35(sources, tokenizer, has_image: bool = False,
                     model_max_length: int = 2048) -> Dict[str, List[np.ndarray]]:
    """Phi-3.5 chat-format tokenization + label masking
    (train.py preprocess_phi35). Returns variable-length int32 arrays."""
    conv = conversation_lib.conv_templates["phi35"].copy()
    conversations = _apply_template(sources, conv)

    def tok(text):
        if has_image:
            return tokenizer_image_token(text, tokenizer)
        return list(tokenizer(text).input_ids)

    input_ids = [np.asarray(tok(c)[:model_max_length], np.int32)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]
    sep = "<|end|>\n"

    for conversation, target in zip(conversations, targets):
        total_len = len(target)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i in range(1, len(rounds) - 1, 2):
            if i == 1:
                rou = rounds[i - 1] + sep + rounds[i] + sep + rounds[i + 1]
                parts0 = rounds[i - 1] + sep + rounds[i]
            else:
                rou = rounds[i] + sep + rounds[i + 1]
                parts0 = rounds[i]
            parts0 += sep
            round_len = len(tok(rou))
            instruction_len = len(tok(parts0)) - 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            # tokenization mismatch: drop the sample's loss (reference
            # behavior, train.py "Phi3 tokenization mismatch" warning)
            target[:] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": targets}


def preprocess_plain(sources, tokenizer) -> Dict[str, List[np.ndarray]]:
    """Projector-pretrain format: '<image>caption\\n'; only the caption +
    trailing sep are supervised (train.py:995-1016 exactly: the first
    human turn is REPLACED by the bare image token, the sequence is
    tokenized via tokenizer_image_token — so a BOS-adding tokenizer
    keeps its BOS — and the first len(tok('<image>')) positions are
    masked)."""
    input_ids, labels = [], []
    sep = conversation_lib.conv_templates["plain"].sep
    for source in sources:
        assert len(source) == 2
        conversation = "<image>" + source[1]["value"] + sep
        ids = np.asarray(tokenizer_image_token(conversation, tokenizer),
                         np.int32)
        tgt = ids.copy()
        masked = len(tokenizer_image_token("<image>", tokenizer))
        tgt[:masked] = IGNORE_INDEX
        input_ids.append(ids)
        labels.append(tgt)
    return {"input_ids": input_ids, "labels": labels}


def _tok_fn(tokenizer, has_image):
    def tok(text):
        if has_image:
            return tokenizer_image_token(text, tokenizer)
        return list(tokenizer(text).input_ids)
    return tok


def _tokenize_conversations(conversations, tok, model_max_length):
    input_ids = [np.asarray(tok(c)[:model_max_length], np.int32)
                 for c in conversations]
    return input_ids, [ids.copy() for ids in input_ids]


def preprocess_v1(sources, tokenizer, has_image: bool = False,
                  model_max_length: int = 2048):
    """Vicuna-v1 two-separator format (train.py:730-811): rounds split on
    '</s>', instruction span = up to ' ASSISTANT: ' (+BOS handling via the
    reference's -2 offset)."""
    conv = conversation_lib.conv_templates["v1"].copy()
    conversations = _apply_template(sources, conv)
    tok = _tok_fn(tokenizer, has_image)
    input_ids, targets = _tokenize_conversations(conversations, tok,
                                                 model_max_length)
    sep = conv.sep + conv.roles[1] + ": "
    legacy_adjust = not getattr(tokenizer, "legacy", True)
    for conversation, target in zip(conversations, targets):
        total_len = len(target)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(tok(rou))
            instruction_len = len(tok(parts[0])) - 2
            if i != 0 and legacy_adjust:
                round_len -= 1
                instruction_len -= 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": targets}


def preprocess_llama_2(sources, tokenizer, has_image: bool = False,
                       model_max_length: int = 2048):
    """[INST] format (train.py:444-526): rounds split on '</s>',
    instruction span = up to '[/INST] '. --version llama_2 selects the
    conv_llama_2 template (safety system prompt, '<s>' round separator,
    reference conversation.py:374-385), not mistral_instruct."""
    conv = conversation_lib.conv_templates["llama_2"].copy()
    conversations = _apply_template(sources, conv)
    tok = _tok_fn(tokenizer, has_image)
    input_ids, targets = _tokenize_conversations(conversations, tok,
                                                 model_max_length)
    sep = "[/INST] "
    for conversation, target in zip(conversations, targets):
        total_len = len(target)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for rou in rounds:
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(tok(rou))
            instruction_len = len(tok(parts[0])) - 2
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": targets}


def preprocess_phi3(sources, tokenizer, has_image: bool = False,
                    model_max_length: int = 2048):
    """Phi-3 format (train.py:527-626): consecutive round PAIRS joined on
    '<|end|>\\n'; first round keeps its full length, later rounds overlap
    by one separator token."""
    conv = conversation_lib.conv_templates["phi3"].copy()
    conversations = _apply_template(sources, conv)
    tok = _tok_fn(tokenizer, has_image)
    input_ids, targets = _tokenize_conversations(conversations, tok,
                                                 model_max_length)
    sep = "<|end|>\n"
    for conversation, target in zip(conversations, targets):
        total_len = len(target)
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i in range(0, len(rounds) - 1, 2):
            rou = rounds[i] + sep + rounds[i + 1]
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(tok(rou))
            instruction_len = len(tok(parts[0])) - 1
            if cur_len == 1:
                target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
                cur_len += round_len
            else:
                target[cur_len:cur_len + instruction_len - 1] = IGNORE_INDEX
                cur_len += round_len - 1
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": targets}


def _preprocess_im_start(sources, tokenizer, conv, regroup,
                         has_image: bool, model_max_length: int,
                         start_len: int):
    """Shared MPT/SmolLM '<|im_start|>' masking (train.py:812-994): rounds
    regrouped per `regroup`, instruction span = up to sep+assistant-role."""
    conversations = _apply_template(sources, conv)
    tok = _tok_fn(tokenizer, has_image)
    input_ids, targets = _tokenize_conversations(conversations, tok,
                                                 model_max_length)
    sep = conv.sep + conv.roles[1]
    legacy_adjust = getattr(tokenizer, "legacy", False)
    for conversation, target in zip(conversations, targets):
        total_len = len(target)
        re_rounds = regroup(conversation.split(conv.sep), conv.sep)
        cur_len = start_len
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(tok(rou))
            instruction_len = len(tok(parts[0])) - 1
            if i != 0 and legacy_adjust:
                round_len += 1
                instruction_len += 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
    return {"input_ids": input_ids, "labels": targets}


def preprocess_mpt(sources, tokenizer, has_image: bool = False,
                   model_max_length: int = 2048):
    """MPT chatml format (train.py:812-898): first re-round is
    system+user+assistant, then user+assistant pairs."""
    def regroup(rounds, sep):
        out = [sep.join(rounds[:3])]
        for idx in range(3, len(rounds), 2):
            out.append(sep.join(rounds[idx:idx + 2]))
        return out

    return _preprocess_im_start(
        sources, tokenizer, conversation_lib.conv_templates["mpt"].copy(),
        regroup, has_image, model_max_length, start_len=0)


def preprocess_smollm(sources, tokenizer, has_image: bool = False,
                      model_max_length: int = 2048):
    """SmolLM chatml format (train.py:899-994): user+assistant pairs, each
    re-round closed with the separator."""
    def regroup(rounds, sep):
        out = []
        for idx in range(0, len(rounds), 2):
            r = sep.join(rounds[idx:idx + 2])
            out.append(r + sep if r != "" else r)
        return out

    return _preprocess_im_start(
        sources, tokenizer,
        conversation_lib.conv_templates["smollm"].copy(),
        regroup, has_image, model_max_length, start_len=0)


PREPROCESSORS = {
    "phi35": preprocess_phi35,
    "phi3": preprocess_phi3,
    "v1": preprocess_v1,
    "llama_2": preprocess_llama_2,
    "mpt": preprocess_mpt,
    "smollm": preprocess_smollm,
    "plain": preprocess_plain,
}


class LazySupervisedDataset:
    """LLaVA-format conversation json + image folder (train.py:1071-1168)."""

    def __init__(self, data_path, image_folder, tokenizer,
                 image_processor: Optional[ImageProcessorConfig] = None,
                 version: str = "phi35",
                 image_aspect_ratio: Optional[str] = "pad",
                 image_grid_pinpoints=None,
                 model_max_length: int = 2048):
        self.records = json.loads(Path(data_path).read_text())
        self.image_folder = Path(image_folder) if image_folder else None
        self.tokenizer = tokenizer
        self.image_processor = image_processor or ImageProcessorConfig()
        self.version = version
        self.image_aspect_ratio = image_aspect_ratio
        self.image_grid_pinpoints = image_grid_pinpoints
        self.model_max_length = model_max_length

    def __len__(self):
        return len(self.records)

    @property
    def modality_lengths(self) -> List[int]:
        """Positive = has image, negative = text-only (train.py:1109-1118)."""
        out = []
        for rec in self.records:
            n = sum(len(c["value"].split())
                    for c in rec["conversations"])
            out.append(n if "image" in rec else -n)
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rec = self.records[i]
        has_image = "image" in rec
        sources = [copy.deepcopy(rec["conversations"])]
        if self.version == "plain":
            d = preprocess_plain(sources, self.tokenizer)
        else:
            d = PREPROCESSORS[self.version](
                sources, self.tokenizer, has_image=has_image,
                model_max_length=self.model_max_length)
        out = {"input_ids": d["input_ids"][0], "labels": d["labels"][0]}
        if has_image:
            from PIL import Image
            # `image` may be a single path or a list (multi-image samples,
            # llava_arch.py:287-330); anyres tiling via grid pinpoints
            names = rec["image"] if isinstance(rec["image"], list) \
                else [rec["image"]]
            imgs = [Image.open(self.image_folder / n) for n in names]
            px = process_images(
                imgs, self.image_processor,
                image_aspect_ratio=self.image_aspect_ratio,
                image_grid_pinpoints=self.image_grid_pinpoints)
            # one image -> [H, W, C] (or [M_tiles, H, W, C] under anyres,
            # since process_anyres_image keeps the tile dim); a list of
            # images -> [N, H, W, C]
            out["image"] = px[0] if len(names) == 1 else np.asarray(px)
        return out


@dataclasses.dataclass
class SupervisedCollator:
    """Right-pad input_ids/labels; stack images; build attention masks
    (train.py:1170-1201). Pads to `pad_to` when given (static shapes for
    jit) else to the batch max."""

    pad_token_id: int
    pad_to: Optional[int] = None
    image_shape: Optional[tuple] = None  # (H, W, C) dummy for text-only

    def __call__(self, samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        max_len = self.pad_to or max(len(s["input_ids"]) for s in samples)
        B = len(samples)
        input_ids = np.full((B, max_len), self.pad_token_id, np.int32)
        labels = np.full((B, max_len), IGNORE_INDEX, np.int32)
        mask = np.zeros((B, max_len), np.int32)
        images = []
        for b, s in enumerate(samples):
            ids = s["input_ids"][:max_len]
            lab = s["labels"][:max_len]
            input_ids[b, :len(ids)] = ids
            labels[b, :len(lab)] = lab
            mask[b, :len(ids)] = 1
            if "image" in s:
                images.append(s["image"])
            elif self.image_shape is not None:
                images.append(np.zeros(self.image_shape, np.float32))
        out = {"input_ids": input_ids, "labels": labels,
               "attention_mask": mask}
        if images:
            out["images"] = np.stack(images)
        return out


class LengthGroupedSampler:
    """Megabatch shuffling grouped by modality then length
    (llava_trainer.py:140-232): multimodal and text-only samples land in
    separate megabatches, each sorted by length for padding efficiency."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 world_mult: int = 1, seed: int = 0):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.mega = batch_size * max(world_mult, 1) * 4
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        mm = [i for i, l in enumerate(self.lengths) if l > 0]
        txt = [i for i, l in enumerate(self.lengths) if l <= 0]
        order = []
        for group in (mm, txt):
            if not group:
                continue
            perm = rng.permutation(len(group))
            shuffled = [group[j] for j in perm]
            # Keep batches modality-pure (static batch structure on TPU):
            # drop each modality's sub-batch remainder.
            n = (len(shuffled) // self.batch_size) * self.batch_size
            shuffled = shuffled[:n]
            for s in range(0, len(shuffled), self.mega):
                chunk = shuffled[s:s + self.mega]
                chunk.sort(key=lambda i: abs(self.lengths[i]), reverse=True)
                order.append(chunk)
        rng.shuffle(order)
        flat = [i for chunk in order for i in chunk]
        for s in range(0, len(flat) - self.batch_size + 1, self.batch_size):
            yield flat[s:s + self.batch_size]
