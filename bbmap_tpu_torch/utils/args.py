"""``key=value`` CLI flag system.

Mirrors the reference flag conventions (reference: dna/Parser.java:33-120,
docs/readme_config.txt): case-insensitive keys, ``null`` literal, K/M/G
suffixes, ``t/f`` booleans, ``config=file`` inlining with position-dependent
override, and first-positional-argument-as-input sniffing.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


def parse_kmg(value: str) -> int:
    """Parse integers with binary K/M/G/T suffixes (reference:
    dna/Parser.java parseKMG / Tools.parseKMG)."""
    s = value.strip().lower()
    mult = 1
    if s and s[-1] in "kmgtbe":
        suffix = s[-1]
        if suffix == "b":  # 'b' = bases = x1 (e.g. 100b)
            s = s[:-1]
        else:
            mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30,
                    "t": 1 << 40, "e": 10 ** 18}[suffix]
            s = s[:-1]
    return int(float(s) * mult)


def parse_bool(value: Optional[str]) -> bool:
    """t/true/1 -> True; f/false/0 -> False; bare flag -> True
    (reference: Tools.parseBoolean)."""
    if value is None:
        return True
    v = value.strip().lower()
    if v in ("t", "true", "1", "yes", "y", ""):
        return True
    if v in ("f", "false", "0", "no", "n", "null", "none"):
        return False
    raise ValueError(f"cannot parse boolean from {value!r}")


def is_java_flag(arg: str) -> bool:
    """JVM passthrough flags the reference ignores (reference:
    dna/Parser.isJavaFlag)."""
    return arg.startswith("-Xmx") or arg.startswith("-Xms") or arg in (
        "-ea", "-da", "-eoom") or arg.startswith("-XX")


def split_arg(arg: str) -> Tuple[str, Optional[str]]:
    """Split one argument into (key, value); value None for bare flags.
    Keys are lowercased; leading dashes stripped (reference accepts both
    ``in=x`` and ``-in=x``)."""
    while arg.startswith("-") and not is_java_flag(arg):
        arg = arg[1:]
    if "=" in arg:
        k, v = arg.split("=", 1)
        if v.lower() == "null":
            v = None
        return k.lower(), v
    return arg.lower(), None


def expand_config(args: Sequence[str]) -> List[str]:
    """Inline ``config=file`` arguments, position-dependent
    (reference: docs/readme_config.txt:7-27)."""
    out: List[str] = []
    for arg in args:
        k, v = split_arg(arg)
        if k == "config" and v:
            with open(v) as fh:
                for line in fh:
                    line = line.split("#", 1)[0].strip()
                    if line:
                        out.append(line)
        else:
            out.append(arg)
    return out


class Args:
    """Parsed argument set with typed getters.

    ``parse`` keeps the last occurrence of each key (later args override
    earlier, matching the reference's sequential-assignment parse loops) and
    records positional arguments.
    """

    def __init__(self) -> None:
        self.kv: Dict[str, Optional[str]] = {}
        self.order: List[Tuple[str, Optional[str]]] = []
        self.positional: List[str] = []

    @classmethod
    def parse(cls, argv: Iterable[str]) -> "Args":
        self = cls()
        argv = expand_config(list(argv))
        for i, arg in enumerate(argv):
            if not arg or is_java_flag(arg):
                continue
            k, v = split_arg(arg)
            if v is None and "=" not in arg and (
                    os.path.exists(arg) or arg == "stdin" or
                    arg.startswith("stdin.")):
                # first-positional-arg-as-input sniffing
                # (reference: align2/BBMap.java:311-316)
                self.positional.append(arg)
                continue
            self.kv[k] = v
            self.order.append((k, v))
        return self

    def has(self, *keys: str) -> bool:
        return any(k in self.kv for k in keys)

    def get(self, *keys: str, default: Optional[str] = None) -> Optional[str]:
        for k in keys:
            if k in self.kv:
                return self.kv[k]
        return default

    def get_bool(self, *keys: str, default: bool = False) -> bool:
        for k in keys:
            if k in self.kv:
                return parse_bool(self.kv[k])
        return default

    def get_int(self, *keys: str, default: int = 0) -> int:
        for k in keys:
            if k in self.kv and self.kv[k] is not None:
                return parse_kmg(self.kv[k])
        return default

    def get_float(self, *keys: str, default: float = 0.0) -> float:
        for k in keys:
            if k in self.kv and self.kv[k] is not None:
                return float(self.kv[k])
        return default

    def pop(self, *keys: str) -> Optional[str]:
        out = None
        for k in keys:
            if k in self.kv:
                out = self.kv.pop(k)
        return out
