"""Port parity of the chat layer: the port's own copies of chat.py,
jinja.py, grammar/json_partial.py, utils/logging.py and utils/console.py
against the JAX package's, on the inputs of tests/test_jinja.py and
tests/test_tools.py. Every comparison is exact (the modules are standard
library code; the same input gives the same string)."""

import io
import json
import time

import pytest

from test_jinja import CHATML_TPL, GEMMA_TPL, LLAMA3_TPL, MSGS, ZEPHYR_TPL
from tpullm import chat as jchat
from tpullm import jinja as jjinja
from tpullm.grammar import json_partial as jjson_partial
from tpullm.utils import console as jconsole
from tpullm.utils import logging as jlog

from tpullm_torch import chat, jinja
from tpullm_torch.grammar import json_partial
from tpullm_torch.utils import console
from tpullm_torch.utils import logging as tlog

# the message lists of tests/test_jinja.py (and one with a tool turn)
CONVERSATIONS = {
    "four turns": MSGS,
    "system first": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "Hi"},
                     {"role": "assistant", "content": "Hello"},
                     {"role": "user", "content": "Bye"}],
    "two turns": [{"role": "user", "content": "Hi"}, {"role": "assistant", "content": "Yo"}],
    "one user turn": [{"role": "user", "content": "  spaced  \n"}],
}

# the templates of tests/test_jinja.py's detection tests, and None
DETECT = [None, "... <start_of_turn> ...", "...[SYSTEM_PROMPT]...", "<|end|> <|assistant|>",
          "x <|im_sep|> y", "x <|im_middle|> y", "x <|header_start|> y", "GPT4 Correct User:",
          "Human: ... Assistant: </s>", "### Instruction: ... <|EOT|>",
          "SYSTEM: x USER: y ASSISTANT", "<|START_OF_TURN_TOKEN|>", "[gMASK]<sop>", "<用户>",
          "[|system|] [|assistant|]", "<|start_of_role|>", "<|im_start|> stuff",
          "USER: ASSISTANT:", "uses <|message_sep|> and <|role_sep|>",
          "...<|start_header_id|>...", "[INST] x [/INST]", "<|user|> <|assistant|>", ""]

TOOL_TEXTS = [
    'I will check.\n<tool_call>\n{"name": "get_weather", "arguments": {"city": "Paris"}}\n'
    '</tool_call>',
    '{"name": "f", "arguments": {"x": 1}}',
    "just text { not json }",
    "<think>step 1</think>The answer is 4.",
    "no reasoning",
    '<tool_call>{"name": "a", "arguments": {}}</tool_call> and '
    '<tool_call>{"name": "b", "arguments": {"y": [1, 2]}}</tool_call>',
]

TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string"},
                                                    "unit": {"enum": ["C", "F"]}},
                   "required": ["city"]}}}]


def test_builtin_tables_match():
    assert list(chat.BUILTIN) == list(jchat.BUILTIN)


@pytest.mark.parametrize("gen", [True, False], ids=["gen", "no-gen"])
@pytest.mark.parametrize("conv", list(CONVERSATIONS))
@pytest.mark.parametrize("name", list(jchat.BUILTIN))
def test_builtin_renderer_as_jax(name, conv, gen):
    msgs = CONVERSATIONS[conv]
    assert chat.BUILTIN[name](msgs, gen) == jchat.BUILTIN[name](msgs, gen)


@pytest.mark.parametrize("template", DETECT)
def test_detect_builtin_as_jax(template):
    assert chat.detect_builtin(template) == jchat.detect_builtin(template)


@pytest.mark.parametrize("tpl", [CHATML_TPL, LLAMA3_TPL, ZEPHYR_TPL, GEMMA_TPL, None,
                                 "...<|start_header_id|>..."],
                         ids=["chatml", "llama3", "zephyr", "gemma", "none", "detected"])
@pytest.mark.parametrize("conv", list(CONVERSATIONS))
def test_apply_chat_template_as_jax(tpl, conv):
    """Jinja templates through the port's jinja.py (a template that raises
    falls back to the detected builtin in both), builtins by detection."""
    msgs = CONVERSATIONS[conv]
    kw = dict(bos_token="<s>", eos_token="</s>")
    assert chat.apply_chat_template(tpl, msgs, True, **kw) == \
        jchat.apply_chat_template(tpl, msgs, True, **kw)


def test_jinja_errors_and_render_as_jax():
    for src, ctx in [("{{ x | upper }}-{{ y | length }}", dict(x="ab", y=[1, 2])),
                     ("{% for i in range(3) %}{{ loop.index }}{% endfor %}", {}),
                     ("{% set ns = namespace(n=0) %}{% for i in [1,2] %}{% set ns.n = ns.n + i %}"
                      "{% endfor %}{{ ns.n }}", {})]:
        assert jinja.render(src, **ctx) == jjinja.render(src, **ctx)
    with pytest.raises(jinja.RaisedException):
        jinja.Template("{{ raise_exception('no') }}").render()
    with pytest.raises(jinja.TemplateError):
        jinja.Template("{{ x.__class__ }}").render(x=1)


@pytest.mark.parametrize("text", TOOL_TEXTS)
def test_tool_calls_and_reasoning_as_jax(text):
    assert chat.parse_tool_calls(text) == jchat.parse_tool_calls(text)
    assert chat.extract_reasoning(text) == jchat.extract_reasoning(text)


@pytest.mark.parametrize("choice", [None, "required", "auto"])
def test_tool_call_grammar_as_jax(choice):
    assert chat.tool_call_grammar(TOOLS, choice) == jchat.tool_call_grammar(TOOLS, choice)


@pytest.mark.parametrize("step", [1, 3, 7])
def test_streaming_tool_call_parser_as_jax(step):
    """The streaming parser fed in jagged pieces: the same events."""
    text = ('I will check. <tool_call>{"name": "get_weather", '
            '"arguments": {"city": "Paris", "unit": "C"}}</tool_call> done')
    port, ref = chat.StreamingToolCallParser(), jchat.StreamingToolCallParser()
    got, want = [], []
    for i in range(0, len(text), step):
        got.extend(port.feed(text[i:i + step]))
        want.extend(ref.feed(text[i:i + step]))
    got.extend(port.flush())
    want.extend(ref.flush())
    assert json.dumps(got, default=str) == json.dumps(want, default=str) and got


@pytest.mark.parametrize("frag", ['{"a": 1', '{"a": "x', '[1, 2, {"b": [', '{"name": "f", "ar',
                                  '{"a": 1}', "", "plain", '{"a": tr'])
def test_json_partial_as_jax(frag):
    assert json_partial.parse_partial_json(frag) == jjson_partial.parse_partial_json(frag)


def test_console_put_is_utf8_safe_as_jax():
    """Pieces that split a code point: the same bytes reach the stream."""
    pieces = [b"a\xe6", b"\xbc", b"\xa2b", "c", b"\xf0\x9f", b"\x98\x80", b"\xff"]
    outs = []
    for mod in (console, jconsole):
        buf = io.StringIO()
        con = mod.Console(stream=buf, use_color=False)
        for p in pieces:
            con.put(p)
        con.flush_partial()
        con.cleanup()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == "a漢b" + "c😀�"


@pytest.mark.parametrize("timestamps,prefix", [(False, False), (True, True)])
def test_logger_levels_and_sinks(tmp_path, timestamps, prefix):
    """The port's logger: verbosity gates levels, output always passes,
    the file sink takes every level but output, a paused log holds its
    lines back until resumed; the format as the JAX package's."""
    stream = io.StringIO()
    log = tlog.AsyncLog(stream=stream)
    log.set_colors(False)
    log.set_timestamps(timestamps)
    log.set_prefix(prefix)
    path = tmp_path / "log.txt"
    log.set_file(str(path))
    log.set_verbosity(tlog.LEVEL_WARN)
    log.pause()
    log.add(tlog.LEVEL_INFO, "hidden info")
    log.add(tlog.LEVEL_WARN, "shown warn")
    log.add(tlog.LEVEL_OUTPUT, "data")
    time.sleep(0.05)
    assert stream.getvalue() == ""
    log.resume()
    deadline = time.monotonic() + 5.0
    while stream.getvalue().count("\n") < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    out = stream.getvalue().splitlines()
    assert len(out) == 2 and out[1] == "data" and out[0].endswith("shown warn")
    assert ("W shown warn" in out[0]) == prefix
    ref = jlog.AsyncLog(stream=io.StringIO())
    for lg in (log, ref):
        lg.set_colors(False)
        lg.set_timestamps(False)
        lg.set_prefix(prefix)
    assert log._format(tlog.LEVEL_WARN, 1.0, "m") == ref._format(jlog.LEVEL_WARN, 1.0, "m")
    assert path.read_text() == "shown warn\n"
