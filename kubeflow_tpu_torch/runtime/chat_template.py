"""Chat templates: OpenAI ``messages`` → a single model prompt string.

The ``/v1/chat/completions`` surface (runtime/server.py) receives a role-
tagged conversation; the model consumes one token stream. The mapping is
a *template* — deployment configuration, not code: real checkpoints ship
their own conversation format, and serving the wrong one silently
degrades the model. Three sources, picked by ``load_template``:

- a builtin name (``role-tags`` — the default, a simple explicit format
  appropriate for the untrained/finetuned-here models; ``chatml`` — the
  widely-adopted ``<|im_start|>`` format many public checkpoints use);
- ``tokenizer`` — delegate to the configured HuggingFace tokenizer's own
  ``apply_chat_template`` (the format the checkpoint was trained with);
- a path to a JSON file ``{"turn": "...{role}...{content}...",
  "generation_prompt": "..."}`` for custom formats without code changes.

A verbatim copy of ``kubeflow_tpu/runtime/chat_template.py`` (stdlib
only): the PyTorch package keeps its own copy so that it imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

# OpenAI chat roles this server accepts. "tool"/"function" messages carry
# call results that need model-specific formats — rejected loudly rather
# than rendered as a guess.
ALLOWED_ROLES = ("system", "user", "assistant")


def validate_messages(messages) -> list[dict]:
    """OpenAI-shape validation, loud on anything we would misrender."""
    if not isinstance(messages, list) or not messages:
        raise ValueError("'messages' must be a non-empty array")
    for i, msg in enumerate(messages):
        if not isinstance(msg, dict):
            raise ValueError(f"messages[{i}] must be an object")
        role = msg.get("role")
        if role not in ALLOWED_ROLES:
            raise ValueError(
                f"messages[{i}].role must be one of {ALLOWED_ROLES} "
                f"(got {role!r}; tool/function messages need a "
                f"model-specific template this server does not guess)")
        content = msg.get("content")
        if not isinstance(content, str) or not content:
            # OpenAI allows content parts (arrays) for multimodal input;
            # a text-only LM server must refuse, not str() them
            raise ValueError(f"messages[{i}].content must be a non-empty "
                             f"string")
    return messages


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    """One conversation turn format + the assistant generation cue.

    ``turn`` is a ``str.format`` template with ``{role}`` and
    ``{content}`` placeholders applied per message;
    ``generation_prompt`` is appended once at the end so the model
    continues as the assistant."""
    name: str
    turn: str
    generation_prompt: str

    def render(self, messages, add_generation_prompt: bool = True) -> str:
        validate_messages(messages)
        text = "".join(
            self.turn.format(role=m["role"], content=m["content"])
            for m in messages)
        return text + (self.generation_prompt if add_generation_prompt
                       else "")


BUILTIN = {
    "role-tags": ChatTemplate(
        name="role-tags",
        turn="<|{role}|>\n{content}\n",
        generation_prompt="<|assistant|>\n"),
    "chatml": ChatTemplate(
        name="chatml",
        turn="<|im_start|>{role}\n{content}<|im_end|>\n",
        generation_prompt="<|im_start|>assistant\n"),
}


class TokenizerChatTemplate:
    """Delegates to a HuggingFace tokenizer's own chat template — the
    conversation format the checkpoint was actually trained with."""

    name = "tokenizer"

    def __init__(self, tokenizer):
        if not callable(getattr(tokenizer, "apply_chat_template", None)):
            raise ValueError(
                "chat template 'tokenizer' requires a tokenizer with "
                "apply_chat_template (pass --tokenizer with a chat-"
                "templated HF tokenizer, or pick a builtin template)")
        self._tokenizer = tokenizer

    def render(self, messages, add_generation_prompt: bool = True) -> str:
        validate_messages(messages)
        try:
            return self._tokenizer.apply_chat_template(
                messages, tokenize=False,
                add_generation_prompt=add_generation_prompt)
        except ValueError:
            raise
        except Exception as e:  # noqa: BLE001 — a jinja TemplateError
            # (e.g. a Llama/Mistral template rejecting non-alternating
            # roles) is a CLIENT-conversation error: surface as
            # ValueError so the HTTP layer answers 400, not 500
            raise ValueError(
                f"chat template rejected the conversation: "
                f"{type(e).__name__}: {e}") from e


def load_template(spec: str | None = None, tokenizer=None):
    """Resolve a template spec: builtin name, ``tokenizer``, or a JSON
    file path. ``None`` → the ``role-tags`` default."""
    if spec is None or spec in BUILTIN:
        return BUILTIN[spec or "role-tags"]
    if spec == "tokenizer":
        return TokenizerChatTemplate(tokenizer)
    path = pathlib.Path(spec)
    try:
        raw = json.loads(path.read_text())
    except OSError as e:
        raise ValueError(
            f"chat template {spec!r} is neither a builtin "
            f"({', '.join(sorted(BUILTIN))}, tokenizer) nor a readable "
            f"JSON file: {e}") from None
    except ValueError as e:
        raise ValueError(f"chat template file {spec!r} is not valid "
                         f"JSON: {e}") from None
    if not isinstance(raw, dict) or \
            not isinstance(raw.get("turn"), str) or \
            not isinstance(raw.get("generation_prompt"), str):
        raise ValueError(
            f"chat template file {spec!r} must be an object with string "
            f"'turn' (with {{role}}/{{content}} placeholders) and "
            f"'generation_prompt' fields")
    try:  # fail at load time, not on the first request
        ChatTemplate("_probe", raw["turn"],
                     raw["generation_prompt"]).render(
            [{"role": "user", "content": "probe"}])
    except (KeyError, IndexError, ValueError, AttributeError) as e:
        # AttributeError: format placeholders like {role.nope} fail at
        # attribute access, not key lookup
        raise ValueError(f"chat template file {spec!r} has a bad 'turn' "
                         f"format string: {e}") from None
    return ChatTemplate(name=str(raw.get("name", path.stem)),
                        turn=raw["turn"],
                        generation_prompt=raw["generation_prompt"])
