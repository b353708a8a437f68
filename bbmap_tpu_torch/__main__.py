"""Tool dispatcher: ``python -m bbmap_tpu_torch <tool> key=value ...``

The port's counterpart of ``python -m bbmap_tpu``. The ported tools are
the short-read mapper ``bbmap``, the long-read mappers ``mappacbio`` and
``mappacbioskimmer``, and the read simulator and SAM grader the smoke run
uses (``randomreads``, ``gradesam``). Each entry names a module and its
entry point.
"""

from __future__ import annotations

import importlib
import sys

TOOLS = {
    "bbmap": ("bbmap_tpu_torch.tools.bbmap", "main"),
    "mappacbio": ("bbmap_tpu_torch.tools.mappacbio", "main"),
    "mappacbioskimmer": ("bbmap_tpu_torch.tools.mappacbio", "skimmer_main"),
    "randomreads": ("bbmap_tpu_torch.tools.randomreads", "main"),
    "gradesam": ("bbmap_tpu_torch.tools.gradesam", "main"),
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help", "help"):
        print("usage: python -m bbmap_tpu_torch <tool> key=value ...")
        print("tools: " + ", ".join(sorted(TOOLS)))
        return 0
    tool = sys.argv[1].lower()
    if tool in TOOLS:
        module, entry = TOOLS[tool]
        return getattr(importlib.import_module(module), entry)(sys.argv[2:])
    print(f"unknown tool {tool!r}; available: " + ", ".join(sorted(TOOLS)))
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
