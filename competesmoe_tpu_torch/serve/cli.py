"""Single-process interactive chat CLI (port of
competesmoe_tpu/serve/cli.py).

    python -m competesmoe_tpu_torch.serve.cli [--model-path DIR]
        [--tokenizer DIR] [--image-file IMG] [--load-4bit] [--device cpu]

The reference's `moe_model/serve/cli.py:32-127`: load the model ->
conversation template -> process the image -> streaming generate loop.
Runs on the GPU unless `--device cpu` is given, and raises when no GPU is
present.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np

from ..multimodal.conversation import conv_templates
from ..multimodal.mm_utils import process_images


def chat_loop(adapter, image_path: Optional[str] = None,
              conv_template: str = "phi35", max_new_tokens: int = 256,
              temperature: float = 0.0, speculative: int = 0,
              in_stream=sys.stdin, out_stream=sys.stdout):
    """adapter: eval.TorchLlava. Reads prompts, prints replies token by
    token as they decode (the reference CLI's TextStreamer role,
    moe_model/serve/cli.py:95-118); speculative=K enables prompt-lookup
    speculation (greedy tokens unchanged; temp > 0 through the unbiased
    rejection scheme). Returns the conversation."""
    from ..models.llava import stream_generate

    conv = conv_templates[conv_template].copy()
    px = None
    if image_path:
        from PIL import Image
        img = Image.open(image_path)
        px = process_images([img], adapter.image_processor)
    first = True
    while True:
        out_stream.write(f"{conv.roles[0]}: ")
        out_stream.flush()
        try:
            inp = in_stream.readline()
        except KeyboardInterrupt:
            break
        if not inp:
            break
        inp = inp.strip()
        if not inp or inp in ("exit", "quit"):
            break
        if px is not None and first:
            inp = "<image>\n" + inp
            first = False
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        ids = adapter.tokenizer_ids_for_prompt(prompt, px is not None)
        out_stream.write(f"{conv.roles[1]}: ")
        out_stream.flush()
        tokens: list = []
        printed = ""
        final = ""
        # hold back enough characters that a marker straddling a chunk
        # boundary ('<|end|>' arriving as '<|e' + 'nd|>') is never
        # partially printed; flushed after the stream ends
        hold = len("<|end|>") - 1
        for chunk in stream_generate(
                adapter.model, np.asarray([ids], np.int32), px,
                max_new_tokens=max_new_tokens, temperature=temperature,
                eos_token_id=getattr(adapter.tokenizer, "eos_token_id",
                                     None),
                stop_token_ids=adapter.stop_token_ids,
                speculative=speculative):
            tokens.extend(int(t) for t in chunk[0])
            text = adapter.tokenizer.decode(tokens,
                                            skip_special_tokens=True)
            if text.endswith("�"):
                continue    # incomplete multi-byte character: wait
            final = text = text.split("<|end|>")[0]
            safe = text[: max(0, len(text) - hold)]
            if safe.startswith(printed) and len(safe) > len(printed):
                out_stream.write(safe[len(printed):])
                out_stream.flush()
                printed = safe
        # the conversation keeps the FINAL decoded text, never what
        # happened to be printable incrementally
        if final.startswith(printed) and len(final) > len(printed):
            out_stream.write(final[len(printed):])
        conv.messages[-1][1] = final.strip()
        out_stream.write("\n")
        out_stream.flush()
    return conv


def main(argv=None):
    from ..device import resolve_device
    from ..eval.llava_adapter import TorchLlava
    from .model_worker import add_model_args, load_model

    ap = argparse.ArgumentParser(description="chat with the model")
    add_model_args(ap)
    ap.add_argument("--image-file", default=None)
    ap.add_argument("--conv-template", default="phi35")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--speculative", type=int, default=0)
    a = ap.parse_args(argv)
    resolve_device(a.device)      # no GPU: raise before loading anything
    model, tokenizer, _ = load_model(a)
    adapter = TorchLlava(model, tokenizer, conv_template=a.conv_template,
                         max_new_tokens=a.max_new_tokens)
    chat_loop(adapter, a.image_file, a.conv_template, a.max_new_tokens,
              a.temperature, a.speculative)


if __name__ == "__main__":
    main()
