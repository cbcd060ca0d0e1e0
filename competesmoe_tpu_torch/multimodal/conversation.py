"""Conversation prompt templates (a copy of
competesmoe_tpu/multimodal/conversation.py, which imports no JAX; the port
keeps its own).

A checkpoint answers well only on the prompt format it was trained on, so
each separator style builds its string byte for byte as the JAX package
does (the reference's moe_model/conversation.py, file:line cited per
style).
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import Any, List, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()
    PHI3 = auto()
    PHI35 = auto()
    SMOLLM = auto()


@dataclasses.dataclass
class Conversation:
    """Keeps conversation history and renders the model prompt
    (conversation.py:39-200)."""

    system: str
    roles: Tuple[str, str]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""
    version: str = "Unknown"

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset, sep_style=self.sep_style, sep=self.sep,
            sep2=self.sep2, version=self.version)

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        messages = self.messages
        if len(messages) > 0 and isinstance(messages[0][1], tuple):
            # first message carries an image: normalize to "<image>\n<text>"
            messages = [list(m) for m in self.messages]
            init_role, init_msg = messages[0]
            init_msg = init_msg[0].replace("<image>", "").strip()
            messages[0] = [init_role, "<image>\n" + init_msg]

        s = self.sep_style
        if s == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
        elif s == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
        elif s in (SeparatorStyle.MPT, SeparatorStyle.SMOLLM):
            ret = self.system + self.sep if s == SeparatorStyle.MPT else ""
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += role + message + self.sep
                else:
                    ret += role
        elif s == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if msg else msg

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    if i == 0:
                        message = wrap_sys(self.system) + message
                    if i % 2 == 0:
                        message = wrap_inst(message)
                        ret += ("<s>" + message) if i == 0 else (
                            self.sep + message)
                    else:
                        ret += " " + message + " " + self.sep2
            ret = ret.lstrip(self.sep)
        elif s == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += message + seps[i % 2]
        elif s in (SeparatorStyle.PHI3, SeparatorStyle.PHI35):
            ret = ""
            if s == SeparatorStyle.PHI35:
                ret = "<|system|>\n" + self.system + self.sep
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    if i % 2 == 0:
                        ret += (f"<|{role.lower()}|>\n" + message + self.sep
                                + "<|assistant|>\n")
                    else:
                        ret += message + self.sep2
        else:
            raise ValueError(f"Invalid style: {s}")
        return ret


conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence "
           "assistant. The assistant gives helpful, detailed, and polite "
           "answers to the user's questions.",
    roles=("USER", "ASSISTANT"), version="v1", messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>")

conv_mistral_instruct = Conversation(
    system="", roles=("USER", "ASSISTANT"), version="llama_v2",
    messages=[], offset=0, sep_style=SeparatorStyle.LLAMA_2, sep="",
    sep2="</s>")

conv_phi_3_instruct = Conversation(
    system="", roles=("USER", "ASSISTANT"), version="phi3", messages=[],
    offset=0, sep_style=SeparatorStyle.PHI3, sep="<|end|>\n",
    sep2="<|end|>\n")

conv_phi_35_instruct = Conversation(
    system="You are a helpful assistant.", roles=("USER", "ASSISTANT"),
    version="phi35", messages=[], offset=0,
    sep_style=SeparatorStyle.PHI35, sep="<|end|>\n", sep2="<|end|>\n")

conv_smollm_instruct = Conversation(
    system="", roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="smollm", messages=[], offset=0,
    sep_style=SeparatorStyle.SMOLLM, sep="<|im_end|>\n")

conv_llava_plain = Conversation(
    system="", roles=("", ""), version="plain", messages=[], offset=0,
    sep_style=SeparatorStyle.PLAIN, sep="\n")

# byte-exact reference templates (conversation.py:374-398): --version
# llama_2 selects conv_llama_2 (full safety system prompt, '<s>' round
# separator), NOT the system-less mistral_instruct — checkpoint fidelity
# depends on the exact system bytes (incl. the double space after
# 'safe.')
conv_llama_2 = Conversation(
    system="You are a helpful, respectful and honest assistant. Always "
           "answer as helpfully as possible, while being safe.  Your "
           "answers should not include any harmful, unethical, racist, "
           "sexist, toxic, dangerous, or illegal content. Please ensure "
           "that your responses are socially unbiased and positive in "
           "nature.\n\nIf a question does not make any sense, or is not "
           "factually coherent, explain why instead of answering "
           "something not correct. If you don't know the answer to a "
           "question, please don't share false information.",
    roles=("USER", "ASSISTANT"), version="llama_v2", messages=[],
    offset=0, sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>")

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user "
           "provides, "
           "and assist the user with a variety of tasks using natural "
           "language.",
    roles=("USER", "ASSISTANT"), version="llama_v2", messages=[],
    offset=0, sep_style=SeparatorStyle.LLAMA_2, sep="<s>", sep2="</s>")

conv_mpt = Conversation(
    system="<|im_start|>system\nA conversation between a user and an "
           "LLM-based AI assistant. The assistant gives helpful and "
           "honest answers.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt", messages=[], offset=0, sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>")

conv_templates = {
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "mistral_instruct": conv_mistral_instruct,
    "llama_2": conv_llama_2,
    "llava_llama_2": conv_llava_llama_2,
    "phi3": conv_phi_3_instruct,
    "phi35": conv_phi_35_instruct,
    "smollm": conv_smollm_instruct,
    "plain": conv_llava_plain,
    "mpt": conv_mpt,
}

default_conversation = conv_phi_35_instruct
