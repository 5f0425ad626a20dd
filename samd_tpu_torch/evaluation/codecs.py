"""Codecs: text questions <-> token ids for the evaluation runner
(counterpart of ``samd_tpu/evaluation/codecs.py``).

Two chat conventions of the reference's evaluation scripts: FastChat's
vicuna template (``VicunaCodec``) and ``tokenizer.apply_chat_template``
for Llama-3 (``ChatTemplateCodec``), beside the token-id
``runner.IdentityCodec``.  Each takes a tokenizer object; nothing here
imports transformers.

Multi-turn semantics: each turn threads the FULL conversation transcript
through the template, as FastChat's ``conv.append_message`` +
``get_prompt`` does.  Codecs expose that as
``encode_conversation(turns, answers)``, where ``turns`` holds the i + 1
user messages of the current turn and ``answers`` the i model answers so
far.
"""

from __future__ import annotations

from typing import List, Sequence


class TokenizerCodec:
    """Plain encode/decode through an HF tokenizer."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer

    def encode(self, turn: str) -> List[int]:
        return self.tokenizer.encode(turn)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    def encode_conversation(self, turns: Sequence[str],
                            answers: Sequence[str]) -> List[int]:
        """Default transcript: newline-joined alternation (no chat markup)."""
        parts = []
        for i, t in enumerate(turns):
            parts.append(t)
            if i < len(answers):
                parts.append(answers[i])
        return self.encode("\n".join(parts))


class VicunaCodec(TokenizerCodec):
    """FastChat vicuna v1.1 conversation convention (roles USER/ASSISTANT,
    sep " ", sep2 "</s>"): the transcript format FastChat's
    ``get_conversation_template("vicuna")`` produces."""

    SYSTEM = ("A chat between a curious user and an artificial intelligence "
              "assistant. The assistant gives helpful, detailed, and polite "
              "answers to the user's questions.")
    ROLES = ("USER", "ASSISTANT")
    SEP = " "
    SEP2 = "</s>"

    def transcript(self, turns: Sequence[str],
                   answers: Sequence[str]) -> str:
        """system + alternating "USER: q ASSISTANT: a</s>" blocks, ending
        with a bare "ASSISTANT:" generation prompt for the current turn."""
        ret = self.SYSTEM + self.SEP
        for i, t in enumerate(turns):
            ret += f"{self.ROLES[0]}: {t}{self.SEP}"
            if i < len(answers):
                ret += f"{self.ROLES[1]}: {answers[i]}{self.SEP2}"
            else:
                ret += f"{self.ROLES[1]}:"
        return ret

    def encode(self, turn: str) -> List[int]:
        return self.encode_conversation([turn], [])

    def encode_conversation(self, turns: Sequence[str],
                            answers: Sequence[str]) -> List[int]:
        return self.tokenizer.encode(self.transcript(turns, answers))


class ChatTemplateCodec(TokenizerCodec):
    """``tokenizer.apply_chat_template`` (Llama-3 style)."""

    def _messages(self, turns: Sequence[str], answers: Sequence[str]):
        msgs = []
        for i, t in enumerate(turns):
            msgs.append({"role": "user", "content": t})
            if i < len(answers):
                msgs.append({"role": "assistant", "content": answers[i]})
        return msgs

    def encode(self, turn: str) -> List[int]:
        return self.encode_conversation([turn], [])

    def encode_conversation(self, turns: Sequence[str],
                            answers: Sequence[str]) -> List[int]:
        return self.tokenizer.apply_chat_template(
            self._messages(turns, answers), add_generation_prompt=True)
