"""The benchmark's own CPU tests: ``python -m pytest h100_bench/tests``
from the repository's root. They need no card and import no JAX."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
