"""Reading/writing ``.properties`` metadata files.

Format-compatible with the Java ``Properties`` files the reference framework
persists next to every graph artifact (see the property-file documentation at
BVGraph.java:238-291): ``key=value``
lines, ``#`` comments, minimal backslash escaping.
"""

from __future__ import annotations

import os


def load_properties(path: str | os.PathLike) -> dict[str, str]:
    props: dict[str, str] = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        pending = ""
        for raw in f:
            line = pending + raw.strip()
            pending = ""
            if not line or line[0] in "#!":
                continue
            if line.endswith("\\") and not line.endswith("\\\\"):
                pending = line[:-1]
                continue
            for sep in ("=", ":"):
                i = _find_sep(line, sep)
                if i >= 0:
                    key, value = line[:i].strip(), line[i + 1 :].strip()
                    break
            else:
                key, value = line, ""
            props[_unescape(key)] = _unescape(value)
    return props


def store_properties(path: str | os.PathLike, props: dict[str, object], comment: str = "") -> None:
    with open(path, "w", encoding="utf-8") as f:
        if comment:
            f.write(f"#{comment}\n")
        for key, value in props.items():
            f.write(f"{_escape(str(key))}={_escape(str(value), is_key=False)}\n")


def _find_sep(line: str, sep: str) -> int:
    i = 0
    while True:
        i = line.find(sep, i)
        if i <= 0:
            return i
        if line[i - 1] != "\\":
            return i
        i += 1


def _unescape(s: str) -> str:
    if "\\" not in s:
        return s
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            n = s[i + 1]
            out.append({"t": "\t", "n": "\n", "r": "\r"}.get(n, n))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _escape(s: str, is_key: bool = True) -> str:
    s = s.replace("\\", "\\\\")
    if is_key:
        s = s.replace("=", "\\=").replace(":", "\\:").replace(" ", "\\ ")
    return s.replace("\t", "\\t").replace("\n", "\\n").replace("\r", "\\r")
