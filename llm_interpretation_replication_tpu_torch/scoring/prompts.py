"""Prompt formatting (a copy of ``scoring/prompts.py``): the 100-question
sweep's few-shot and instruct formats, the packed-scoring demonstration
spelling (``scoring.packed`` assembles packed rows from it), and the
perturbation sweeps' binary and confidence prompts.

These strings are behavioural data, kept byte-identical to the reference so
the statistics reproduce.
"""

from __future__ import annotations

FEW_SHOT_PREFIX = (
    "Question: Is \"soup\" a \"beverage\"? Answer either 'Yes' or 'No', "
    "without any other text.\nAnswer: No.\n\n"
    "Question: Is a \"tweet\" a \"publication\"? Answer either 'Yes' or 'No', "
    "without any other text.\nAnswer: Yes.\n\n"
)

ANSWER_INSTRUCTION = "Answer either 'Yes' or 'No', without any other text."

#: Separator between a packed question's demonstration answer and the next
#: question: two newlines, the few-shot scaffold's question separator.
PACKED_SEPARATOR = "\n\n"


def format_packed_demo(answer: str) -> str:
    """Packed scoring: the demonstration appended after a question's answer
    anchor -- ``" {answer}.\\n\\n"``, the few-shot scaffold's answer
    spelling (``Answer: No.\\n\\n``) without the ``Answer:`` cue the
    question text already ends with."""
    return f" {answer}.{PACKED_SEPARATOR}"


def format_base_prompt(question: str) -> str:
    """Base checkpoints: 2-shot prefix + Question/Answer scaffold."""
    return f"{FEW_SHOT_PREFIX}Question: {question} {ANSWER_INSTRUCTION}\nAnswer:"


def format_instruct_prompt(question: str, model_name: str = "") -> str:
    """Instruction-tuned checkpoints: bare question + instruction; Baichuan
    gets its chat wrapping."""
    if "baichuan" in model_name.lower():
        return f"<human>: {question} {ANSWER_INSTRUCTION}\n<bot>:"
    return f"{question} {ANSWER_INSTRUCTION}"


def format_prompt(question: str, is_base_model: bool, model_name: str = "") -> str:
    if is_base_model:
        return format_base_prompt(question)
    return format_instruct_prompt(question, model_name)


def format_prompt_parts(question: str, is_base_model: bool,
                        model_name: str = "") -> tuple:
    """``(prefix, suffix)`` split of :func:`format_prompt` for the engine's
    prefix-reuse path (``runtime.engine.score_prefixed``): the parts joined
    reproduce the prompt byte for byte, and the prefix holds the shared
    text -- the 2-shot preamble for base checkpoints (identical across all
    100 questions, so it tokenizes once per sweep), the bare question for
    instruct checkpoints."""
    if is_base_model:
        return (FEW_SHOT_PREFIX,
                f"Question: {question} {ANSWER_INSTRUCTION}\nAnswer:")
    if "baichuan" in model_name.lower():
        return (f"<human>: {question}", f" {ANSWER_INSTRUCTION}\n<bot>:")
    return (question, f" {ANSWER_INSTRUCTION}")


def format_binary_prompt(main_part: str, response_format: str) -> str:
    """Perturbation-sweep binary prompt: ``{rephrased_main} {response_format}``
    (the workbook's 'Full Rephrased Prompt' column)."""
    return f"{main_part} {response_format}"


def format_confidence_prompt(main_part: str, confidence_format: str) -> str:
    return f"{main_part} {confidence_format}"
