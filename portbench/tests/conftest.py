"""Puts the checkout's root (for ``portbench``) and ``src`` (for the port,
which some tests hold the frozen copies against) on the path."""

import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# torch's sparse CSR tensors warn that their support is in beta
warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
