"""framebench's own tests: `python -m pytest framebench/tests` from the root
of the repository (the card's tests, marked gpu, skip without a card)."""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for p in (HERE, ROOT, os.path.join(HERE, "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)
