"""Interactive console layer (≡ common/console.cpp).

The reference's console module owns three jobs for the chat CLI:
  * display classes — prompt vs generated vs error text get distinct ANSI
    colors (console::set_display), reset on exit
  * UTF-8 safety — model output arrives token-by-token and a token can end
    mid-codepoint; bytes are buffered until a complete character is
    available so the terminal never sees a broken sequence
  * readline-ish input with multiline continuation ("\\" suffix)

Python's stdin handles most raw-mode concerns; this module keeps the
display-class state machine, the UTF-8 partial-output buffer, and the
multiline reader, all no-oping color when stdout is not a TTY.

The JAX package's utils/console.py (standard library only), kept as the
port's own copy.
"""

from __future__ import annotations

import sys

# display classes ≡ console::display_type
RESET = "reset"
PROMPT = "prompt"
USER_INPUT = "user_input"
ERROR = "error"

_ANSI = {
    RESET: "\033[0m",
    PROMPT: "\033[33m",       # yellow, ≡ console.cpp prompt color
    USER_INPUT: "\033[1;32m",  # bold green
    ERROR: "\033[31m",
}


class Console:
    def __init__(self, stream=None, use_color: bool | None = None):
        self.stream = stream or sys.stdout
        self.use_color = (self.stream.isatty() if use_color is None
                          else use_color)
        self._display = RESET
        self._pending = b""  # bytes of an incomplete UTF-8 sequence

    def set_display(self, display: str):
        """≡ console::set_display — switch the active color class."""
        if self._display == display:
            return
        self._display = display
        if self.use_color:
            self.stream.write(_ANSI.get(display, _ANSI[RESET]))
            self.stream.flush()

    # -- UTF-8-safe streaming output ----------------------------------------

    def put(self, piece: str | bytes):
        """Write a detokenized piece; buffers trailing partial UTF-8 bytes
        (a byte-fallback token can split a codepoint across pieces)."""
        data = piece.encode("utf-8") if isinstance(piece, str) else piece
        data = self._pending + data
        self._pending = b""
        # find the longest prefix that decodes cleanly
        for cut in range(len(data), max(len(data) - 4, -1), -1):
            try:
                text = data[:cut].decode("utf-8")
            except UnicodeDecodeError:
                continue
            self._pending = data[cut:]
            if text:
                self.stream.write(text)
                self.stream.flush()
            return
        # >4 trailing junk bytes: emit replacement chars, drop the buffer
        self.stream.write(data.decode("utf-8", errors="replace"))
        self.stream.flush()

    def flush_partial(self):
        """End-of-generation: surface any buffered partial bytes."""
        if self._pending:
            self.stream.write(self._pending.decode("utf-8", errors="replace"))
            self._pending = b""
            self.stream.flush()

    def cleanup(self):
        self.flush_partial()
        if self.use_color:
            self.stream.write(_ANSI[RESET])
            self.stream.flush()

    # -- input --------------------------------------------------------------

    def readline(self, prompt: str = "> ") -> str:
        """Multiline-aware input: a trailing backslash continues the line
        (≡ console::readline multiline_input)."""
        self.set_display(USER_INPUT)
        try:
            lines = []
            while True:
                try:
                    line = input(prompt if not lines else "... ")
                except EOFError:
                    break
                if line.endswith("\\"):
                    lines.append(line[:-1])
                    continue
                lines.append(line)
                break
            return "\n".join(lines)
        finally:
            self.set_display(RESET)
