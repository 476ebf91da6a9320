"""Chat templating + tool-call parsing.

Reference: src/llama-chat.cpp (≈40 builtin non-Jinja templates with
string-sniff detection) + common/jinja (own Jinja engine for GGUF-embedded
templates) + common/chat-parser* (tool-call extraction from model output).

GGUF-embedded Jinja templates render through the package's own jinja.py (no
external dependency); when a model has no template, the detected builtin
renderer applies. The JAX package's chat.py, which uses no JAX, kept as the
port's own copy.
"""

from __future__ import annotations

import json
import re
from typing import Sequence

from .jinja import Template, TemplateError

Message = dict  # {"role": str, "content": str}


def _render_chatml(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n")
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _render_llama2_family(messages, add_generation_prompt, *,
                          support_system=True, bos_inside_history=False,
                          strip=False):
    """llama2 template + sys/sys-bos/sys-strip variants
    (llama-chat.cpp LLM_CHAT_TEMPLATE_LLAMA_2*)."""
    out = ["[INST] "]
    inside = True
    for m in messages:
        content = m["content"].strip() if strip else m["content"]
        role = m["role"]
        if not inside:
            inside = True
            out.append("<s>[INST] " if bos_inside_history else "[INST] ")
        if role == "system":
            if support_system:
                out.append(f"<<SYS>>\n{content}\n<</SYS>>\n\n")
            else:
                out.append(content + "\n")
        elif role == "user":
            out.append(content + " [/INST]")
        else:
            out.append(content + "</s>")
            inside = False
    return "".join(out)


def _render_llama2(messages, add_generation_prompt):
    return _render_llama2_family(messages, add_generation_prompt,
                                 support_system=False)


def _render_mistral_family(messages, add_generation_prompt, *,
                           leading_space=False, trailing_space=True,
                           trim_assistant=False):
    """Official mistral v1/v3/v3-tekken templates
    (llama-chat.cpp LLM_CHAT_TEMPLATE_MISTRAL_V1/V3/V3_TEKKEN)."""
    lead = " " if leading_space else ""
    trail = " " if trailing_space else ""
    out = []
    inside = False
    for m in messages:
        if not inside:
            out.append(f"{lead}[INST]{trail}")
            inside = True
        role, content = m["role"], m["content"]
        if role == "system":
            out.append(content + "\n\n")
        elif role == "user":
            out.append(content + lead + "[/INST]")
        else:
            out.append(trail + (content.strip() if trim_assistant else content) + "</s>")
            inside = False
    return "".join(out)


def _render_llama3(messages, add_generation_prompt):
    out = ["<|begin_of_text|>"]
    for m in messages:
        out.append(
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m['content']}<|eot_id|>"
        )
    if add_generation_prompt:
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    return "".join(out)


def _render_gemma(messages, add_generation_prompt):
    # system folds into the first user turn (≡ llama-chat.cpp gemma handling)
    out = []
    system = ""
    for m in messages:
        if m["role"] == "system":
            system = m["content"]
            continue
        role = "model" if m["role"] == "assistant" else m["role"]
        content = m["content"]
        if system and role == "user":
            content = system + "\n\n" + content
            system = ""
        out.append(f"<start_of_turn>{role}\n{content}<end_of_turn>\n")
    if add_generation_prompt:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _render_mistral_v7(messages, add_generation_prompt, *, sp=" "):
    # official mistral v7 / v7-tekken (tekken drops the leading space;
    # llama-chat.cpp:246-261)
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"[SYSTEM_PROMPT]{sp}{m['content']}[/SYSTEM_PROMPT]")
        elif m["role"] == "user":
            out.append(f"[INST]{sp}{m['content']}[/INST]")
        else:
            out.append(f"{sp}{m['content']}</s>")
    return "".join(out)


def _render_phi3(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m['content']}<|end|>\n")
    if add_generation_prompt:
        out.append("<|assistant|>\n")
    return "".join(out)


def _render_zephyr(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n")
    if add_generation_prompt:
        out.append("<|assistant|>\n")
    return "".join(out)


def _render_vicuna(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"{m['content']}\n\n")
        elif m["role"] == "user":
            out.append(f"USER: {m['content']}\n")
        else:
            out.append(f"ASSISTANT: {m['content']}</s>\n")
    if add_generation_prompt:
        out.append("ASSISTANT:")
    return "".join(out)


def _render_deepseek3(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(m["content"])
        elif m["role"] == "user":
            out.append(f"<｜User｜>{m['content']}")
        else:
            out.append(f"<｜Assistant｜>{m['content']}<｜end▁of▁sentence｜>")
    if add_generation_prompt:
        out.append("<｜Assistant｜>")
    return "".join(out)


def _render_falcon3(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m['content']}\n")
    if add_generation_prompt:
        out.append("<|assistant|>\n")
    return "".join(out)


def _render_monarch(messages, add_generation_prompt):
    # mlabonne/AlphaMonarch-7B: <s> before every turn but the first
    out = []
    for i, m in enumerate(messages):
        bos = "" if i == 0 else "<s>"
        out.append(f"{bos}{m['role']}\n{m['content']}</s>\n")
    if add_generation_prompt:
        out.append("<s>assistant\n")
    return "".join(out)


def _render_orion(messages, add_generation_prompt):
    # OrionStarAI/Orion-14B-Chat: system merges into the next user turn
    out = []
    system = ""
    for m in messages:
        if m["role"] == "system":
            system += m["content"]
        elif m["role"] == "user":
            pre = f"{system}\n\n" if system else ""
            system = ""
            out.append(f"Human: {pre}{m['content']}\n\nAssistant: </s>")
        else:
            out.append(f"{m['content']}</s>")
    return "".join(out)


def _render_openchat(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"{m['content']}<|end_of_turn|>")
        else:
            role = m["role"].capitalize()
            out.append(f"GPT4 Correct {role}: {m['content']}<|end_of_turn|>")
    if add_generation_prompt:
        out.append("GPT4 Correct Assistant:")
    return "".join(out)


def _render_vicuna_orca(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"SYSTEM: {m['content']}\n")
        elif m["role"] == "user":
            out.append(f"USER: {m['content']}\n")
        else:
            out.append(f"ASSISTANT: {m['content']}</s>\n")
    if add_generation_prompt:
        out.append("ASSISTANT:")
    return "".join(out)


def _render_deepseek(messages, add_generation_prompt):
    # deepseek-coder instruct
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(m["content"])
        elif m["role"] == "user":
            out.append(f"### Instruction:\n{m['content']}\n")
        else:
            out.append(f"### Response:\n{m['content']}\n<|EOT|>\n")
    if add_generation_prompt:
        out.append("### Response:\n")
    return "".join(out)


def _render_deepseek2(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"{m['content']}\n\n")
        elif m["role"] == "user":
            out.append(f"User: {m['content']}\n\n")
        else:
            out.append(f"Assistant: {m['content']}<｜end▁of▁sentence｜>")
    if add_generation_prompt:
        out.append("Assistant:")
    return "".join(out)


def _render_command_r(messages, add_generation_prompt):
    role_tok = {"system": "SYSTEM_TOKEN", "user": "USER_TOKEN",
                "assistant": "CHATBOT_TOKEN"}
    out = []
    for m in messages:
        tok = role_tok.get(m["role"], "USER_TOKEN")
        out.append(
            f"<|START_OF_TURN_TOKEN|><|{tok}|>{m['content'].strip()}"
            "<|END_OF_TURN_TOKEN|>"
        )
    if add_generation_prompt:
        out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    return "".join(out)


def _render_chatglm4(messages, add_generation_prompt):
    out = ["[gMASK]<sop>"]
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m['content']}")
    if add_generation_prompt:
        out.append("<|assistant|>\n")
    return "".join(out)


def _render_glmedge(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|{m['role']}|>\n{m['content']}")
    if add_generation_prompt:
        out.append("<|assistant|>")
    return "".join(out)


def _render_minicpm(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "user":
            out.append(f"<用户>{m['content'].strip()}<AI>")
        else:
            out.append(m["content"].strip())
    return "".join(out)


def _render_exaone3(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"[|system|]{m['content'].strip()}[|endofturn|]\n")
        elif m["role"] == "user":
            out.append(f"[|user|]{m['content'].strip()}\n")
        else:
            out.append(f"[|assistant|]{m['content'].strip()}[|endofturn|]\n")
    if add_generation_prompt:
        out.append("[|assistant|]")
    return "".join(out)


def _render_rwkv_world(messages, add_generation_prompt):
    # requires "\n\n" as the EOT; Assistant: appended right after the last user
    out = []
    for i, m in enumerate(messages):
        role = {"system": "System", "user": "User",
                "assistant": "Assistant"}.get(m["role"], "User")
        out.append(f"{role}: {m['content'].strip()}\n\n")
        if m["role"] == "user" and i == len(messages) - 1:
            out.append("Assistant:")
    return "".join(out)


def _render_granite(messages, add_generation_prompt):
    out = []
    for m in messages:
        role = m["role"]
        call = "<|tool_call|>" if role == "assistant_tool_call" else ""
        out.append(f"<|start_of_role|>{role}<|end_of_role|>{call}"
                   f"{m['content']}<|end_of_text|>\n")
    if add_generation_prompt:
        out.append("<|start_of_role|>assistant<|end_of_role|>")
    return "".join(out)


def _render_phi4(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|im_start|>{m['role']}<|im_sep|>{m['content']}<|im_end|>")
    if add_generation_prompt:
        out.append("<|im_start|>assistant<|im_sep|>")
    return "".join(out)


def _render_llama4(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|header_start|>{m['role']}<|header_end|>\n\n"
                   f"{m['content'].strip()}<|eot|>")
    if add_generation_prompt:
        out.append("<|header_start|>assistant<|header_end|>\n\n")
    return "".join(out)


def _render_kimi_k2(messages, add_generation_prompt):
    pre = {"system": "<|im_system|>system", "user": "<|im_user|>user",
           "assistant": "<|im_assistant|>assistant",
           "tool": "<|im_system|>tool"}
    out = []
    for m in messages:
        out.append(f"{pre.get(m['role'], '<|im_user|>user')}<|im_middle|>"
                   f"{m['content']}<|im_end|>")
    if add_generation_prompt:
        out.append("<|im_assistant|>assistant<|im_middle|>")
    return "".join(out)


def _render_gigachat(messages, add_generation_prompt):
    out = []
    i = 0
    if messages and messages[0]["role"] == "system":
        out.append(f"<s>{messages[0]['content']}<|message_sep|>")
        i = 1
    else:
        out.append("<s>")
    for m in messages[i:]:
        if m["role"] == "user":
            out.append(f"user<|role_sep|>{m['content']}<|message_sep|>"
                       "available functions<|role_sep|>[]<|message_sep|>")
        elif m["role"] == "assistant":
            out.append(f"assistant<|role_sep|>{m['content']}<|message_sep|>")
    if add_generation_prompt:
        out.append("assistant<|role_sep|>")
    return "".join(out)


def _render_megrez(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|role_start|>{m['role']}<|role_end|>{m['content']}<|turn_end|>")
    if add_generation_prompt:
        out.append("<|role_start|>assistant<|role_end|>")
    return "".join(out)


def _render_openai_moe(messages, add_generation_prompt):
    # Harmony-style (gpt-oss)
    out = []
    for m in messages:
        end = "<|return|>" if m["role"] == "assistant" else "<|end|>"
        out.append(f"<|start|>{m['role']}<|message|>{m['content']}{end}")
    if add_generation_prompt:
        out.append("<|start|>assistant")
    return "".join(out)


def _render_hunyuan_moe(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"<|startoftext|>{m['content']}<|extra_4|>")
        elif m["role"] == "assistant":
            out.append(f"{m['content']}<|eos|>")
        else:
            out.append(f"<|startoftext|>{m['content']}<|extra_0|>")
    return "".join(out)


def _render_seed_oss(messages, add_generation_prompt):
    out = []
    for m in messages:
        content = m["content"].strip() if m["role"] == "assistant" else m["content"]
        out.append(f"<seed:bos>{m['role']}\n{content}<seed:eos>")
    if add_generation_prompt:
        out.append("<seed:bos>assistant\n")
    return "".join(out)


def _render_chatglm3(messages, add_generation_prompt):
    out = ["[gMASK]sop"]
    for m in messages:
        out.append(f"<|{m['role']}|>\n {m['content']}")
    if add_generation_prompt:
        out.append("<|assistant|>")
    return "".join(out)


def _render_yandex(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "user":
            out.append(f" Пользователь: {m['content']}\n\n")
        elif m["role"] == "assistant":
            out.append(f" Ассистент: {m['content']}\n\n")
    if add_generation_prompt:
        out.append(" Ассистент:[SEP]")
    return "".join(out)


def _render_bailing(messages, add_generation_prompt, think=False):
    out = []
    for m in messages:
        role = "HUMAN" if m["role"] == "user" else m["role"].upper()
        out.append(f"<role>{role}</role>{m['content']}")
    if add_generation_prompt:
        out.append("<role>ASSISTANT</role>")
        if think:
            out.append("<think>")
    return "".join(out)


def _render_bailing2(messages, add_generation_prompt):
    out = []
    if not messages or messages[0]["role"] != "system":
        out.append("<role>SYSTEM</role>detailed thinking off<|role_end|>")
    for m in messages:
        role = "HUMAN" if m["role"] == "user" else m["role"].upper()
        out.append(f"<role>{role}</role>{m['content']}<|role_end|>")
    if add_generation_prompt:
        out.append("<role>ASSISTANT</role>")
    return "".join(out)


def _render_dots1(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"<|system|>{m['content']}<|endofsystem|>")
        elif m["role"] == "user":
            out.append(f"<|userprompt|>{m['content']}<|endofuserprompt|>")
        else:
            out.append(f"<|response|>{m['content']}<|endofresponse|>")
    if add_generation_prompt:
        out.append("<|response|>")
    return "".join(out)


def _render_exaone4(messages, add_generation_prompt):
    out = []
    for m in messages:
        c = m["content"].strip()
        if m["role"] == "system":
            out.append(f"[|system|]{c}[|endofturn|]\n")
        elif m["role"] == "user":
            out.append(f"[|user|]{c}\n")
        elif m["role"] == "assistant":
            out.append(f"[|assistant|]{c}[|endofturn|]\n")
        elif m["role"] == "tool":
            out.append(f"[|tool|]{c}[|endofturn|]\n")
    if add_generation_prompt:
        out.append("[|assistant|]")
    return "".join(out)


def _render_grok2(messages, add_generation_prompt):
    out = []
    for m in messages:
        if m["role"] == "system":
            out.append(f"System: {m['content'].strip()}<|separator|>\n\n")
        elif m["role"] == "user":
            out.append(f"Human: {m['content'].strip()}<|separator|>\n\n")
        elif m["role"] == "assistant":
            out.append(f"Assistant: {m['content']}<|separator|>\n\n")
    if add_generation_prompt:
        out.append("Assistant:")
    return "".join(out)


def _render_hunyuan_dense(messages, add_generation_prompt):
    out = []
    for i, m in enumerate(messages):
        role = m["role"]
        if i == 0 and role == "system":
            out.append(m["content"] + "<｜hy_place▁holder▁no▁3｜>")
        if role == "assistant":
            out.append("<｜hy_Assistant｜>" + m["content"] + "<｜hy_place▁holder▁no▁2｜>")
        elif role == "user":
            out.append("<｜hy_User｜>" + m["content"] + "<｜hy_Assistant｜>")
    return "".join(out)


def _render_pangu(messages, add_generation_prompt):
    out = []
    for i, m in enumerate(messages):
        role, content = m["role"], m["content"]
        if i == 0 and role != "system":
            out.append("[unused9]系统：[unused10]")
        if role == "system":
            out.append(f"[unused9]系统：{content}[unused10]")
        elif role == "user":
            out.append(f"[unused9]用户：{content}[unused10]")
        elif role == "assistant":
            out.append(f"[unused9]助手：{content}[unused10]")
        elif role == "tool":
            out.append(f"[unused9]工具：{content}[unused10]")
        elif role == "function":
            out.append(f"[unused9]方法：{content}[unused10]")
    if add_generation_prompt:
        out.append("[unused9]助手：")
    return "".join(out)


def _render_solar_open(messages, add_generation_prompt):
    out = []
    for m in messages:
        out.append(f"<|begin|>{m['role']}<|content|>{m['content']}<|end|>")
    if add_generation_prompt:
        out.append("<|begin|>assistant")
    return "".join(out)


def _render_smolvlm(messages, add_generation_prompt):
    out = ["<|im_start|>"]
    for m in messages:
        if m["role"] == "system":
            out.append(m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append(f"User: {m['content']}<end_of_utterance>\n")
        else:
            out.append(f"Assistant: {m['content']}<end_of_utterance>\n")
    if add_generation_prompt:
        out.append("Assistant:")
    return "".join(out)


def _render_exaone_moe(messages, add_generation_prompt):
    out = []
    for m in messages:
        c = m["content"].strip()
        if m["role"] == "system":
            out.append(f"<|system|>\n{c}<|endofturn|>\n")
        elif m["role"] == "user":
            out.append(f"<|user|>\n{c}<|endofturn|>\n")
        else:
            out.append(f"<|assistant|>\n{c}<|endofturn|>\n")
    if add_generation_prompt:
        out.append("<|assistant|>\n")
    return "".join(out)


BUILTIN = {
    "chatml": _render_chatml,
    "llama2": _render_llama2,
    "llama3": _render_llama3,
    "gemma": _render_gemma,
    "mistral-v7": _render_mistral_v7,
    "mistral-v7-tekken": lambda m, g: _render_mistral_v7(m, g, sp=""),
    "phi3": _render_phi3,
    "zephyr": _render_zephyr,
    "vicuna": _render_vicuna,
    "deepseek3": _render_deepseek3,
    "falcon3": _render_falcon3,
    "monarch": _render_monarch,
    "orion": _render_orion,
    "openchat": _render_openchat,
    "vicuna-orca": _render_vicuna_orca,
    "deepseek": _render_deepseek,
    "deepseek2": _render_deepseek2,
    "command-r": _render_command_r,
    "chatglm4": _render_chatglm4,
    "glmedge": _render_glmedge,
    "minicpm": _render_minicpm,
    "exaone3": _render_exaone3,
    "rwkv-world": _render_rwkv_world,
    "granite": _render_granite,
    "phi4": _render_phi4,
    "llama4": _render_llama4,
    "kimi-k2": _render_kimi_k2,
    "gigachat": _render_gigachat,
    "megrez": _render_megrez,
    "gpt-oss": _render_openai_moe,
    "hunyuan-moe": _render_hunyuan_moe,
    "seed-oss": _render_seed_oss,
    "llama2-sys": lambda m, g: _render_llama2_family(m, g),
    "llama2-sys-bos": lambda m, g: _render_llama2_family(m, g, bos_inside_history=True),
    "llama2-sys-strip": lambda m, g: _render_llama2_family(m, g, strip=True),
    "mistral-v1": lambda m, g: _render_mistral_family(m, g, leading_space=True),
    "mistral-v3": lambda m, g: _render_mistral_family(m, g, trim_assistant=True),
    "mistral-v3-tekken": lambda m, g: _render_mistral_family(m, g, trailing_space=False),
    "chatglm3": _render_chatglm3,
    "yandex": _render_yandex,
    "bailing": _render_bailing,
    "bailing-think": lambda m, g: _render_bailing(m, g, think=True),
    "bailing2": _render_bailing2,
    "dots1": _render_dots1,
    "exaone4": _render_exaone4,
    "exaone-moe": _render_exaone_moe,
    "grok-2": _render_grok2,
    "hunyuan-dense": _render_hunyuan_dense,
    "pangu-embedded": _render_pangu,
    "solar-open": _render_solar_open,
    "smolvlm": _render_smolvlm,
}


def detect_builtin(template: str | None) -> str:
    """Template-string → builtin-name detection (≡ llm_chat_detect_template,
    src/llama-chat.cpp string sniffing)."""
    if not template:
        return "chatml"
    if "<|im_sep|>" in template:
        return "phi4"
    if "<|im_middle|>" in template:
        return "kimi-k2"
    if "<|im_start|>" in template:
        return "smolvlm" if "<end_of_utterance>" in template else "chatml"
    if "<|start_header_id|>" in template:
        return "llama3"
    if "<|header_start|>" in template:
        return "llama4"
    if "<start_of_turn>" in template:
        return "gemma"
    if "[SYSTEM_PROMPT]" in template:
        return "mistral-v7"
    if "<|end|>" in template and "<|assistant|>" in template:
        return "phi3"
    if "<|endoftext|>" in template and "<|assistant|>" in template:
        return "zephyr"
    if "bos_token + message['role']" in template:
        return "monarch"
    if "GPT4 Correct " in template:
        return "openchat"
    if "Human: " in template and "Assistant: </s>" in template:
        return "orion"
    if "<｜User｜>" in template:
        return "deepseek3"
    if "'User: ' + message['content'] +" in template or (
        "User: " in template and "<｜end▁of▁sentence｜>" in template
    ):
        return "deepseek2"
    if "### Instruction:" in template and "<|EOT|>" in template:
        return "deepseek"
    if "SYSTEM: " in template and "USER: " in template:
        return "vicuna-orca"
    if "USER:" in template and "ASSISTANT:" in template:
        return "vicuna"
    if "<|START_OF_TURN_TOKEN|>" in template:
        return "command-r"
    if "[gMASK]<sop>" in template:
        return "chatglm4"
    if "<用户>" in template:
        return "minicpm"
    if "[|system|]" in template and "[|assistant|]" in template:
        # [|tool|] marks the EXAONE-4 variant (llm_chat_detect_template)
        return "exaone4" if "[|tool|]" in template else "exaone3"
    if "rwkv-world" in template or "'User: ' + content + '\\n\\nAssistant:'" in template:
        return "rwkv-world"
    if "<|start_of_role|>" in template:
        return "granite"
    if "<|role_sep|>" in template:
        return "gigachat"
    if "<|role_start|>" in template:
        return "megrez"
    if "<|start|>" in template and "<|message|>" in template:
        return "gpt-oss"
    if "<|extra_0|>" in template and "<|extra_4|>" in template:
        return "hunyuan-moe"
    if "<seed:bos>" in template:
        return "seed-oss"
    if "[INST]" in template:
        # official mistral v1/v3/v3-tekken vs llama2-family variants
        # (llm_chat_detect_template [INST] branch)
        if "' [INST] ' + system_message" in template or "[AVAILABLE_TOOLS]" in template:
            if " [INST]" in template:
                return "mistral-v1"
            if '"[INST]"' in template:
                return "mistral-v3-tekken"
            return "mistral-v3"
        if "content.strip()" in template:
            return "llama2-sys-strip"
        if "bos_token + '[INST]" in template:
            return "llama2-sys-bos"
        if "<<SYS>>" in template:
            return "llama2-sys"
        return "llama2"
    if "[gMASK]sop" in template:
        return "chatglm3"
    if " Ассистент:" in template:
        return "yandex"
    if "<role>ASSISTANT</role>" in template:
        if "<|role_end|>" in template:
            return "bailing2"
        if '"HUMAN"' in template and "<think>" in template:
            return "bailing-think"
        return "bailing"
    if "<|endofuserprompt|>" in template:
        return "dots1"
    if "[|tool|]" in template and "[|endofturn|]" in template:
        return "exaone4"
    if "<｜hy_Assistant｜>" in template:
        return "hunyuan-dense"
    if "'Assistant: '  + message['content'] + '<|separator|>" in template or "<|separator|>" in template:
        return "grok-2"
    if "[unused9]系统：[unused10]" in template:
        return "pangu-embedded"
    if "<|begin|>" in template and "<|content|>" in template:
        return "solar-open"
    return "chatml"


def apply_chat_template(
    template: str | None,
    messages: Sequence[Message],
    add_generation_prompt: bool = True,
    tools: list | None = None,
    bos_token: str = "",
    eos_token: str = "",
    **extra,
) -> str:
    """Render a conversation to the model's prompt format."""
    if template and ("{{" in template or "{%" in template):
        try:
            return Template(template).render(
                messages=[dict(m) for m in messages],
                add_generation_prompt=add_generation_prompt,
                tools=tools,
                bos_token=bos_token, eos_token=eos_token,
                **extra,
            )
        except TemplateError:
            pass  # fall back to builtin detection
    return BUILTIN[detect_builtin(template)](list(messages), add_generation_prompt)


# ---------------------------------------------------------------------------
# tool-call extraction (≡ common/chat-parser.cpp streaming parsers, simplified
# to whole-message parsing)
# ---------------------------------------------------------------------------

_HERMES_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
_REASONING_RE = re.compile(r"<think>(.*?)</think>\s*", re.DOTALL)


def extract_reasoning(text: str) -> tuple[str | None, str]:
    """Split <think>…</think> reasoning from the visible content
    (≡ reasoning extraction in common/chat.cpp)."""
    m = _REASONING_RE.search(text)
    if not m:
        return None, text
    return m.group(1).strip(), _REASONING_RE.sub("", text, count=1)


def parse_tool_calls(text: str) -> tuple[str, list[dict]]:
    """Extract tool calls from model output; returns (content, tool_calls)
    in OpenAI shape. Understands hermes-style <tool_call>{json}</tool_call>
    blocks and bare {"name": ..., "arguments": ...} JSON messages."""
    calls: list[dict] = []

    def add(obj):
        name = obj.get("name")
        args = obj.get("arguments", obj.get("parameters", {}))
        if not name:
            return False
        calls.append({
            "id": f"call_{len(calls)}",
            "type": "function",
            "function": {
                "name": str(name),
                "arguments": args if isinstance(args, str) else json.dumps(args, ensure_ascii=False),
            },
        })
        return True

    content = text
    hits = _HERMES_RE.findall(text)
    if hits:
        for h in hits:
            try:
                add(json.loads(h))
            except json.JSONDecodeError:
                continue
        content = _HERMES_RE.sub("", text).strip()
        return content, calls

    open_idx = text.rfind("<tool_call>")
    if open_idx >= 0 and "</tool_call>" not in text[open_idx:]:
        # generation was cut mid-call: heal the partial JSON
        # (≡ common/json-partial.cpp streaming tool-call healing)
        from .grammar.json_partial import parse_partial_json

        obj, _ = parse_partial_json(text[open_idx + len("<tool_call>"):])
        if isinstance(obj, dict) and add(obj):
            return text[:open_idx].strip(), calls

    stripped = text.strip()
    if stripped.startswith("{") and stripped.endswith("}"):
        try:
            obj = json.loads(stripped)
        except json.JSONDecodeError:
            return text, []
        if isinstance(obj, dict) and add(obj):
            return "", calls
    return text, []


def tool_call_grammar(tools: list[dict], tool_choice=None) -> str:
    """GBNF grammar forcing a valid hermes-style tool call
    (≡ common/chat.cpp per-format grammar construction for
    tool_choice=required). The model must emit
    <tool_call>{"name": <one of the tools>, "arguments": <its schema>}</tool_call>.

    tool_choice: None/"required" allows any tool; {"function": {"name": ...}}
    restricts to that tool.
    """
    from .grammar.json_schema import json_schema_to_gbnf

    forced = None
    if isinstance(tool_choice, dict):
        forced = (tool_choice.get("function") or {}).get("name")

    options = []
    for t in tools or []:
        fn = t.get("function", t)
        name = fn.get("name", "")
        if forced and name != forced:
            continue
        options.append({
            "type": "object",
            "properties": {
                "name": {"const": name},
                "arguments": fn.get("parameters") or {"type": "object"},
            },
            "required": ["name", "arguments"],
        })
    if not options:
        raise ValueError("no tools match tool_choice")
    schema = options[0] if len(options) == 1 else {"oneOf": options}
    inner = json_schema_to_gbnf(schema)
    # re-root: the schema grammar's root becomes the payload rule
    inner = inner.replace("root ::=", "tool-json ::=", 1)
    return (
        'root ::= "<tool_call>" space tool-json "</tool_call>" space\n' + inner
    )


# ---------------------------------------------------------------------------
# streaming tool-call diffs (≡ common/chat-parser.cpp incremental parsing:
# the server streams OpenAI `delta.tool_calls[*].function.arguments` chunks
# while the model is still emitting the call)
# ---------------------------------------------------------------------------


class StreamingToolCallParser:
    """Incremental splitter of generated text into content deltas and
    tool-call deltas.

    feed(piece) returns a list of events:
      ("content", text)                      — plain content delta
      ("tool_start", index, name)           — a call's name became known
      ("tool_args", index, args_delta)      — incremental arguments JSON
    Holds back partially-formed ``<tool_call>`` tags so tag fragments never
    leak into content. flush() releases any trailing held text.
    """

    OPEN = "<tool_call>"
    CLOSE = "</tool_call>"

    def __init__(self):
        self.buf = ""  # held-back text (possible tag prefix / call body)
        self.in_call = False
        self.index = -1
        self.name_sent = False
        self.args_sent = ""

    _NAME_RE = re.compile(r'"name"\s*:\s*"((?:[^"\\]|\\.)*)"')
    _ARGS_RE = re.compile(r'"arguments"\s*:\s*')

    @staticmethod
    def _value_end(s: str) -> int:
        """Index one past the balanced JSON value at s[0], or -1 if the
        value is still incomplete."""
        if not s:
            return -1
        if s[0] in "{[":
            depth = 0
            in_str = False
            esc = False
            for i, c in enumerate(s):
                if in_str:
                    if esc:
                        esc = False
                    elif c == "\\":
                        esc = True
                    elif c == '"':
                        in_str = False
                elif c == '"':
                    in_str = True
                elif c in "{[":
                    depth += 1
                elif c in "}]":
                    depth -= 1
                    if depth == 0:
                        return i + 1
            return -1
        if s[0] == '"':
            esc = False
            for i, c in enumerate(s[1:], 1):
                if esc:
                    esc = False
                elif c == "\\":
                    esc = True
                elif c == '"':
                    return i + 1
            return -1
        return -1  # bare literal: wait for the final pass

    def _arg_events(self, body: str, final: bool = False):
        events = []
        m = self._ARGS_RE.search(body)
        if not self.name_sent:
            nm = self._NAME_RE.search(body)
            if nm:
                self.index += 1
                self.name_sent = True
                events.append(("tool_start", self.index, nm.group(1)))
        if not (self.name_sent and m):
            return events
        raw = body[m.end():]
        end = self._value_end(raw)
        if end >= 0:
            args = raw[:end]
        elif final:
            # truncated mid-arguments: heal to a valid JSON string
            from .grammar.json_partial import parse_partial_json

            obj, _ = parse_partial_json(body)
            if isinstance(obj, dict) and "arguments" in obj:
                a = obj["arguments"]
                args = a if isinstance(a, str) else json.dumps(a)
            else:
                args = raw
        else:
            # stream the raw text, holding back a possible outer closer
            args = raw.rstrip()
            if args.endswith("}"):
                args = args[:-1]
        if len(args) > len(self.args_sent) or (final and args != self.args_sent):
            if args.startswith(self.args_sent):
                delta = args[len(self.args_sent):]
            else:
                delta = args  # healing changed the text (rare): resend
            if delta:
                events.append(("tool_args", self.index, delta))
            self.args_sent = args
        return events

    def feed(self, piece: str):
        self.buf += piece
        events = []
        while True:
            if self.in_call:
                end = self.buf.find(self.CLOSE)
                if end >= 0:
                    body = self.buf[:end]
                    events.extend(self._arg_events(body, final=True))
                    self.buf = self.buf[end + len(self.CLOSE):]
                    self.in_call = False
                    self.name_sent = False
                    self.args_sent = ""
                    continue
                events.extend(self._arg_events(self.buf))
                return events
            start = self.buf.find(self.OPEN)
            if start >= 0:
                if start:
                    events.append(("content", self.buf[:start]))
                self.buf = self.buf[start + len(self.OPEN):]
                self.in_call = True
                continue
            # hold back a possible tag prefix at the tail
            keep = 0
            for k in range(min(len(self.OPEN) - 1, len(self.buf)), 0, -1):
                if self.OPEN.startswith(self.buf[-k:]):
                    keep = k
                    break
            emit = self.buf[: len(self.buf) - keep]
            if emit:
                events.append(("content", emit))
            self.buf = self.buf[len(self.buf) - keep:]
            return events

    def flush(self):
        events = []
        if self.in_call:  # truncated call: finalize from healed JSON
            events.extend(self._arg_events(self.buf, final=True))
        elif self.buf:
            events.append(("content", self.buf))
        self.buf = ""
        self.in_call = False
        return events

    @property
    def saw_tool_call(self) -> bool:
        return self.index >= 0
