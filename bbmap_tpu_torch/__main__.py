"""Tool dispatcher: ``python -m bbmap_tpu_torch <tool> key=value ...``

The port's counterpart of ``python -m bbmap_tpu``. Only the ``bbmap``
mapper is ported so far; each tool is a module with main(argv).
"""

from __future__ import annotations

import importlib
import sys

TOOLS = {
    "bbmap": "bbmap_tpu_torch.tools.bbmap",
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help", "help"):
        print("usage: python -m bbmap_tpu_torch <tool> key=value ...")
        print("tools: " + ", ".join(sorted(TOOLS)))
        return 0
    tool = sys.argv[1].lower()
    if tool in TOOLS:
        mod = importlib.import_module(TOOLS[tool])
        return mod.main(sys.argv[2:])
    print(f"unknown tool {tool!r}; available: " + ", ".join(sorted(TOOLS)))
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
