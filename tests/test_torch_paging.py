"""The port's copy of ``PagePool`` (paddle_tpu_torch/serving/paging.py).

The accounting cases of tests/test_paged_kv.py (refcounts, prefix sharing
+ copy-on-write, exhaustion rollback, geometry validation) run against the
port's copy, and a seeded random operation sequence must leave the port's
pool in exactly the JAX package's state.
"""
import numpy as np
import pytest

from paddle_tpu.serving.paging import PagePool as JaxPagePool
from paddle_tpu_torch.serving.paging import PagePool


def test_alloc_release_refcounts():
    pool = PagePool(num_slots=2, num_pages=8, page_size=4, max_len=16)
    assert pool.free_pages == 8
    prompt = np.arange(6, dtype=np.int32)  # 2 pages
    pairs, shared = pool.admit(0, prompt)
    assert (pairs, shared) == ([], 0)
    assert pool.free_pages == 6
    assert pool.pos_map[0, 5] == 5 and pool.pos_map[0, 6] == -1
    pool.release(0)
    assert pool.free_pages == 8
    assert (pool.table[0] == -1).all()
    assert pool.leaked_pages() == 0


def test_prefix_sharing_and_cow():
    pool = PagePool(num_slots=3, num_pages=12, page_size=4, max_len=16)
    prompt = np.arange(10, dtype=np.int32)  # pages 0-1 full, page 2 part
    pool.admit(0, prompt)
    pool.register_prefix("sys", 0, prompt)
    base = pool.free_pages
    # sibling shares 2 full pages, CoWs the partial boundary page
    sib = np.concatenate([prompt, [50, 51]]).astype(np.int32)
    pairs, shared = pool.admit(1, sib, prefix_key="sys")
    assert shared == 10 and len(pairs) == 1
    assert pool.pages_needed(sib, "sys") == 1
    assert pool.free_pages == base - 1
    assert pool.shared_pages >= 2
    assert pool.table[1, 0] == pool.table[0, 0]
    assert pool.table[1, 1] == pool.table[0, 1]
    assert pool.table[1, 2] != pool.table[0, 2]
    # divergent-token prompt must NOT share, even with the key
    other = np.arange(10, dtype=np.int32)[::-1].copy()
    assert pool.admit(2, other, prefix_key="sys") == ([], 0)
    # the registry's ref makes the donor's own next write CoW
    old = int(pool.table[0, 2])
    pr = pool.ensure_writable(0, 10)
    assert pr is not None and pr[0] == old
    assert int(pool.table[0, 2]) != old
    # a write into a FULL shared page (ring wrap) CoWs too
    pr = pool.ensure_writable(1, 16)
    assert pr is not None and pr[0] == pool.table[0, 0]
    assert pool.table[1, 0] != pool.table[0, 0]
    pool.release(0), pool.release(1), pool.release(2)
    assert pool.leaked_pages() == 0
    assert pool.free_pages < 12  # the registry pins the prefix pages
    pool.drop_prefix("sys")
    assert pool.free_pages == 12


def test_exhaustion_raises_and_rolls_back():
    pool = PagePool(num_slots=2, num_pages=4, page_size=4, max_len=16)
    pool.admit(0, np.arange(12, dtype=np.int32))  # 3 pages
    with pytest.raises(MemoryError):
        pool.admit(1, np.arange(8, dtype=np.int32))  # needs 2, 1 free
    assert (pool.table[1] == -1).all()
    assert pool.free_pages == 1
    assert pool.leaked_pages() == 0


def test_geometry_validation():
    with pytest.raises(ValueError):
        PagePool(num_slots=1, num_pages=8, page_size=5, max_len=16)
    with pytest.raises(ValueError):  # pool can't hold one slot
        PagePool(num_slots=1, num_pages=2, page_size=4, max_len=16)


def _state(pool):
    return (pool.table.copy(), pool.pos_map.copy(), pool.refcount.copy(),
            list(pool.free), pool.cow_copies, pool.prefix_hits)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operation_sequence_matches_jax_pool(seed):
    rng = np.random.RandomState(seed)
    pools = [PagePool(4, 24, 4, 32), JaxPagePool(4, 24, 4, 32)]
    system = rng.randint(0, 50, size=9).astype(np.int32)
    for _ in range(200):
        op = rng.randint(5)
        slot = int(rng.randint(4))
        sub = rng.randint(1 << 30)
        for pool in pools:  # identical op stream on both
            r = np.random.RandomState(sub)
            try:
                if op == 0 and (pool.table[slot] < 0).all():
                    n = int(r.randint(1, 20))
                    tail = r.randint(0, 50, size=n).astype(np.int32)
                    prompt = np.concatenate([system, tail])
                    pool.admit(slot, prompt, prefix_key="sys")
                    if r.rand() < 0.5:
                        pool.register_prefix("sys", slot, system)
                elif op == 1:
                    pool.release(slot)
                elif op == 2 and (pool.table[slot] >= 0).any():
                    pool.ensure_writable(slot, int(r.randint(0, 64)))
                elif op == 3:
                    pool.drop_all_prefixes()
            except MemoryError:
                pass
        s_port, s_jax = (_state(p) for p in pools)
        for a, b in zip(s_port, s_jax):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert pools[0].leaked_pages() == pools[1].leaked_pages() == 0
