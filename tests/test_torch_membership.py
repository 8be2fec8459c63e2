"""Digest membership of the PyTorch/CUDA package against the JAX reference:
the same digest sets, the same candidate states (made with numpy from a
seed), the same verdicts — including state words with the top bit set,
where an int32 compare would break the uint32 sort order."""

import numpy as np
import pytest
import torch

import hashcat_a5_table_generator_tpu.ops.membership as j_member
import hashcat_a5_table_generator_tpu_torch.ops.membership as t_member


def _case(seed, n_digests, n_probes, bitmap_bits=None):
    rng = np.random.default_rng(seed)
    digests = rng.integers(0, 256, size=(n_digests, 16), dtype=np.uint8)
    # Half the digests get a top-bit state word 0 (the sort's first key).
    digests[: n_digests // 2, 3] |= 0x80
    ds = t_member.build_digest_set(digests, "md5", bitmap_bits=bitmap_bits)
    present = ds.rows[rng.integers(0, len(ds.rows), size=n_probes // 2)]
    absent = rng.integers(0, 2**32, size=(n_probes - len(present), 4),
                          dtype=np.uint64).astype(np.uint32)
    # Near misses: a present row with its LAST word flipped in the top bit.
    absent[: len(absent) // 4] = present[: len(absent) // 4]
    absent[: len(absent) // 4, 3] ^= np.uint32(0x80000000)
    probes = np.concatenate([present, absent])
    rng.shuffle(probes)
    return ds, probes


def _jax_member(ds, probes):
    import jax.numpy as jnp

    return np.asarray(j_member.digest_member(
        jnp.asarray(probes), jnp.asarray(ds.rows), jnp.asarray(ds.bitmap)
    ))


def _port_member(ds, probes):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))  # noqa: E731
    return t_member.digest_member(t(probes), t(ds.rows),
                                  t(ds.bitmap)).numpy()


@pytest.mark.parametrize("n_digests,bits", [(1, None), (7, None),
                                            (1000, None), (1000, 5),
                                            (5000, 16)])
def test_digest_member_matches_reference(n_digests, bits):
    ds, probes = _case(n_digests, n_digests, 400, bitmap_bits=bits)
    want = _jax_member(ds, probes)
    got = _port_member(ds, probes)
    assert got.dtype == np.bool_ and (got == want).all()
    assert want.any() and not want.all()


def test_empty_digest_set_matches_nothing():
    ds = t_member.build_digest_set([], "md5")
    probes = np.zeros((5, 4), np.uint32)
    assert not _port_member(ds, probes).any()


def test_bitmap_probe_matches_reference():
    import jax.numpy as jnp

    ds, probes = _case(3, 300, 200, bitmap_bits=12)
    want = np.asarray(j_member.bitmap_probe(jnp.asarray(probes),
                                            jnp.asarray(ds.bitmap)))
    got = t_member.bitmap_probe(
        torch.from_numpy(probes.view(np.int32)),
        torch.from_numpy(ds.bitmap.view(np.int32)),
    ).numpy()
    assert (got == want).all()


def test_row_compare_is_unsigned_lexicographic():
    rows = np.array([[0, 0, 0, 1], [0, 0, 0, 0x80000000],
                     [0x80000000, 0, 0, 0], [0xFFFFFFFF] * 4], np.uint32)
    t = torch.from_numpy(rows.view(np.int32))
    for i in range(4):
        for k in range(4):
            le = bool(t_member._row_cmp_le(t[i], t[k]))
            assert le == (tuple(rows[k]) <= tuple(rows[i]))


@pytest.mark.parametrize("n_digests", [1, 300, 3000])
def test_sha1_rows_and_verdicts_match_reference(n_digests):
    """``[D, 5]`` SHA-1 digest sets: rows in the reference's big-endian
    word order (``digest_to_words``), top bits set in every word position
    for some digests, and the same verdicts as the reference's
    ``digest_member`` — near misses in the last word included."""
    import jax.numpy as jnp

    from hashcat_a5_table_generator_tpu_torch.ops.hashes import (
        digest_to_words,
    )

    rng = np.random.default_rng(n_digests)
    raw = rng.integers(0, 256, size=(n_digests, 20), dtype=np.uint8)
    for word in range(5):  # a top bit in each state word for some rows
        raw[word::5, 4 * word] |= 0x80
    digests = [r.tobytes() for r in raw]
    ds = t_member.build_digest_set(digests, "sha1")
    jds = j_member.build_digest_set(digests, "sha1")
    assert ds.rows.shape == (n_digests, 5)
    assert np.array_equal(ds.rows, jds.rows)
    assert np.array_equal(ds.bitmap, jds.bitmap)
    assert {tuple(digest_to_words(d, "sha1")) for d in digests} == \
        {tuple(r) for r in ds.rows}
    present = ds.rows[rng.integers(0, n_digests, size=100)]
    near = present.copy()
    near[:, 4] ^= np.uint32(0x80000000)
    absent = rng.integers(0, 2**32, size=(100, 5),
                          dtype=np.uint64).astype(np.uint32)
    probes = np.concatenate([present, near, absent])
    want = np.asarray(j_member.digest_member(
        jnp.asarray(probes), jnp.asarray(jds.rows), jnp.asarray(jds.bitmap)))
    got = _port_member(ds, probes)
    assert (got == want).all()
    assert got[:100].all() and not got[100:].any()
