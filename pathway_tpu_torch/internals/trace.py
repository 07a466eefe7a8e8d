"""Build-time call-site capture.

When user code builds an operator (``t.select(...)``,
``pw.io.kafka.read(...)``) we remember the line in *their* file that
made the call.  Build errors re-raise annotated with that line, and
runtime row errors carry it into the error-log tables, so a failing UDF
names the user's source line rather than an engine internal.

Parity surface: reference ``python/pathway/internals/trace.py``
(Frame/Trace/trace_user_frame).  The mechanism here is this repo's own:
public API entry points are wrapped in a shim whose code object acts as
a stack sentinel, and the user frame is found by walking the *live*
frame chain outward past the outermost shim to the first frame that
lives outside the package.
"""

from __future__ import annotations

import functools
import linecache
import os
import sys
from dataclasses import dataclass
from typing import Any, Callable

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Exceptions already annotated carry the frame under this attribute, so a
# re-raise through an outer decorated API call never annotates twice.
_ORIGIN_ATTR = "_ptpu_call_site"


@dataclass(frozen=True)
class Frame:
    filename: str
    line_number: int | None
    line: str | None
    function: str

    def is_external(self) -> bool:
        """True for frames outside the pathway_tpu package (and not a
        decorator shim) — i.e. the user's own code."""
        path = os.path.abspath(self.filename)
        if path.startswith(_PACKAGE_DIR + os.sep):
            return False
        return "@beartype" not in self.filename

    def as_dict(self) -> dict:
        return {
            "file": self.filename,
            "line": self.line_number,
            "line_text": self.line,
            "function": self.function,
        }


def _snapshot(frame) -> Frame:
    """Materialize a live frame into a Frame record."""
    code = frame.f_code
    lineno = frame.f_lineno
    text = linecache.getline(code.co_filename, lineno).rstrip("\n") or None
    return Frame(
        filename=code.co_filename,
        line_number=lineno,
        line=text,
        function=code.co_name,
    )


def _locate_call_site(depth: int) -> Frame | None:
    """Walk the live stack outward from ``depth`` callers up.

    Returns the innermost user-code frame that sits *outside* the
    outermost API shim: any candidate found below a shim is inside the
    package's own plumbing and gets discarded when the shim is passed.
    """
    try:
        frame = sys._getframe(depth + 1)
    except ValueError:  # pragma: no cover - stack shallower than depth
        return None
    found: Frame | None = None
    while frame is not None:
        if frame.f_code is _SHIM_CODE:
            found = None
        elif found is None:
            snap_path = os.path.abspath(frame.f_code.co_filename)
            if not snap_path.startswith(_PACKAGE_DIR + os.sep):
                if "@beartype" not in frame.f_code.co_filename:
                    found = _snapshot(frame)
        frame = frame.f_back
    return found


@dataclass(frozen=True)
class Trace:
    user_frame: Frame | None

    @staticmethod
    def from_traceback() -> "Trace":
        return Trace(user_frame=_locate_call_site(1))


def user_frame() -> Frame | None:
    """The user-code frame currently building an operator, if any."""
    return _locate_call_site(1)


def _format_frame(frame: Frame) -> str:
    src = (frame.line or "").strip()
    return (
        f"Occurred here: {frame.filename}:{frame.line_number},"
        f" in {frame.function}\n    {src}"
    )


def _attach_call_site(exc: BaseException, frame: Frame) -> None:
    setattr(exc, _ORIGIN_ATTR, frame)
    note = _format_frame(frame)
    add_note = getattr(exc, "add_note", None)
    if add_note is not None:
        add_note(note)
    else:  # Python < 3.11: emulate PEP 678 so __notes__ consumers work
        notes = getattr(exc, "__notes__", None)
        if notes is None:
            notes = []
            exc.__notes__ = notes
        notes.append(note)


def trace_user_frame(func: Callable) -> Callable:
    """Decorate a public API entry point so exceptions raised while
    building an operator re-raise annotated with the user's call site."""

    @functools.wraps(func)
    def _api_shim(*args: Any, **kwargs: Any):
        try:
            return func(*args, **kwargs)
        except Exception as exc:
            if getattr(exc, _ORIGIN_ATTR, None) is None:
                site = _locate_call_site(1)
                if site is not None:
                    _attach_call_site(exc, site)
            raise

    return _api_shim


# Every _api_shim closure shares one compiled code object; that object is
# the sentinel _locate_call_site scans for.
_SHIM_CODE = trace_user_frame(lambda: None).__code__
