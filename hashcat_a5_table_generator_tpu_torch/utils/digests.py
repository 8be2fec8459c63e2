"""Host-side digest functions (jax-free).

Used by the oracle backend, oracle-fallback words, and hit re-verification;
each must agree byte-for-byte with the device kernels in ``ops.hashes``
(cross-checked in tests/test_hashes.py and tests/test_runtime.py).
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict

from .md4 import md4, ntlm

HOST_DIGEST: Dict[str, Callable[[bytes], bytes]] = {
    "md5": lambda b: hashlib.md5(b).digest(),
    "sha1": lambda b: hashlib.sha1(b).digest(),
    "md4": md4,
    "ntlm": ntlm,
}
