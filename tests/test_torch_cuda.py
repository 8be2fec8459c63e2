"""The PyTorch/CUDA package's kernels on a GPU (``cuda`` marker).

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch with CUDA::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest pins JAX to the CPU.)  Without a
GPU every test here skips.  Inputs come from seeds through the package's
own host code; each kernel is held against its plain PyTorch version on
the card (equal emit masks, equal state on every emitted row, tolerance
0), and a small sweep on the GPU must equal the same sweep on the CPU.
"""

import hashlib

import numpy as np
import pytest
import torch

from hashcat_a5_table_generator_tpu_torch.models.attack import (
    AttackSpec,
    build_plan,
    cut_blocks,
    device_arrays,
)
from hashcat_a5_table_generator_tpu_torch.ops import fused_expand as fe
from hashcat_a5_table_generator_tpu_torch.ops.blocks import superstep_index
from hashcat_a5_table_generator_tpu_torch.ops.membership import (
    build_digest_set,
)
from hashcat_a5_table_generator_tpu_torch.ops.packing import (
    pack_words,
    piece_schema_for,
)
from hashcat_a5_table_generator_tpu_torch.runtime.sweep import (
    Sweep,
    SweepConfig,
)
from hashcat_a5_table_generator_tpu_torch.tables.compile import (
    compile_table,
)
from hashcat_a5_table_generator_tpu_torch.tables.layouts import get_layout

pytestmark = pytest.mark.cuda

SUB = get_layout("qwerty-cyrillic").to_substitution_map()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def words_for(case, seed=0):
    rng = np.random.default_rng(seed)
    if case in ("k1", "pair"):
        return [bytes(rng.integers(97, 123, size=int(rng.integers(3, 11)),
                                   dtype=np.uint8)) for _ in range(300)]
    lo, hi = (40, 64) if case == "2-hash-blocks" else (100, 120)
    out = []
    for _ in range(40):
        w = rng.integers(48, 58, size=int(rng.integers(lo, hi + 1)),
                         dtype=np.uint8)
        pos = rng.choice(len(w), size=6, replace=False)
        w[pos] = rng.integers(97, 123, size=6, dtype=np.uint8)
        out.append(bytes(w))
    return out


@pytest.mark.parametrize("case", ["k1", "pair", "2-hash-blocks",
                                  "3-hash-blocks"])
def test_kernel_matches_plain_version(case, cuda):
    spec, ct = AttackSpec(), compile_table(SUB)
    plan = build_plan(spec, ct, pack_words(words_for(case)))
    pieces = piece_schema_for(plan, ct)
    assert fe.kernel_refusal(spec, plan, ct, pieces) is None
    pair = case == "pair"
    stride = 128
    idx = superstep_index(plan, stride * (2 if pair else 1))
    arrays = device_arrays(plan, pieces, build_digest_set([], "md5"), idx,
                           device=cuda)
    blocks = cut_blocks(arrays, 0, 256, stride * (2 if pair else 1))[:3]
    kw = dict(pieces=pieces, block_stride=stride, min_substitute=1,
              max_substitute=15, pair=pair)
    launches = dict(fe.LAUNCHES)
    state, emit = fe.fused_expand_md5(*blocks, arrays,
                                      out_width=int(plan.out_width), **kw)
    name = "piece_md5_pair" if pair else "piece_md5_k1"
    assert fe.LAUNCHES[name] == launches[name] + 1
    want_state, want_emit = fe.piece_md5_reference(
        *blocks, arrays, hash_blocks=fe._hash_blocks_for(plan.out_width),
        **kw)
    torch.cuda.synchronize()
    assert emit.any()
    assert torch.equal(emit, want_emit)
    assert torch.equal(state[emit], want_state[emit])


def test_sweep_on_the_gpu_equals_the_cpu(cuda):
    words = words_for("k1", seed=1) + words_for("2-hash-blocks", seed=2)[:5]
    digests = [hashlib.md5(w).digest() for w in words[:5]]  # never emitted
    spec, ct = AttackSpec(), compile_table(SUB)
    plan = build_plan(spec, ct, pack_words(words[:40]))
    from hashcat_a5_table_generator_tpu_torch.models.attack import (
        decode_variant,
    )
    for row in range(0, 40, 4):
        digests.append(hashlib.md5(decode_variant(
            plan, ct, spec, row, plan.n_variants[row] // 2)).digest())
    results = [
        Sweep(spec, SUB, words, digests,
              SweepConfig(device=dev, lanes=4096, num_blocks=32,
                          superstep_hit_cap=3)).run_crack()
        for dev in ("cuda", "cpu")
    ]
    got, want = ([(h.word_index, h.variant_rank, h.candidate)
                  for h in r.hits] for r in results)
    assert got == want and len(got) == 10
    assert results[0].n_emitted == results[1].n_emitted
    assert results[0].superstep["replays"] > 0
