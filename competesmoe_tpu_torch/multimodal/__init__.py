"""Prompt templates and image preprocessing of the port."""

from . import conversation, mm_utils  # noqa: F401
from .conversation import (Conversation, SeparatorStyle,  # noqa: F401
                           conv_templates)
