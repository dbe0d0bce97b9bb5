"""The port's ``BlockAllocator`` and prefix chain hashing vs the JAX
package's: the same random interleaving of admissions (prefix lookup,
reservation, sharing), growth, publishing and release gives the same block
ids, the same capacity views and the same invariants at every step, and
drains clean."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serving import block_pool as ref  # noqa: E402
from repro_torch.serving import block_pool as port  # noqa: E402

BS = 4
NUM_BLOCKS = 16


def _same(a, b):
    assert a.free_blocks == b.free_blocks
    assert a.allocated_blocks == b.allocated_blocks
    assert a.allocated_tokens() == b.allocated_tokens()
    a.check_invariants()
    b.check_invariants()


@pytest.mark.parametrize("seed", range(6))
def test_allocator_matches_reference(seed):
    rng = np.random.default_rng(seed)
    # a few shared system prompts, each request appends its own tail
    heads = [rng.integers(0, 50, int(n)).astype(np.int32)
             for n in rng.integers(4, 14, 8)]
    allocs = (ref.BlockAllocator(NUM_BLOCKS, BS),
              port.BlockAllocator(NUM_BLOCKS, BS))
    live = []       # (prompt, table, shared, reserved, worst)
    for _ in range(120):
        op = rng.integers(0, 3)
        if op == 0:                                     # admit
            head = heads[rng.integers(0, len(heads))]
            prompt = np.concatenate(
                [head, rng.integers(0, 50, rng.integers(1, 6))
                 .astype(np.int32)])
            worst = len(prompt) + int(rng.integers(0, 6))
            digests = port.prompt_chain(prompt, BS,
                                        limit=(len(prompt) - 1) // BS)
            assert digests == ref.prompt_chain(prompt, BS,
                                               limit=(len(prompt) - 1) // BS)
            chains = [a.lookup(digests) for a in allocs]
            assert chains[0] == chains[1]
            chain = chains[0]
            costs = [a.revival_cost(chain) for a in allocs]
            assert costs[0] == costs[1]
            need = port.blocks_for(worst, BS) - len(chain)
            ok = [a.can_reserve(need + costs[0]) for a in allocs]
            assert ok[0] == ok[1]
            if not ok[0]:
                continue
            for a in allocs:
                a.reserve(need)
                a.share(chain)
            live.append([prompt, list(chain), len(chain), need, worst])
        elif op == 1 and live:                          # grow
            req = live[rng.integers(0, len(live))]
            lo = min(len(req[1]) * BS, req[4])
            want = port.blocks_for(rng.integers(lo, req[4] + 1), BS)
            if want > len(req[1]):
                got = [a.allocate(want - len(req[1])) for a in allocs]
                assert got[0] == got[1]
                req[1].extend(got[0])
        elif op == 2 and live:                          # finish
            prompt, table, shared, need, worst = live.pop(
                rng.integers(0, len(live)))
            n_full = min(len(prompt) // BS, len(table))
            digests = port.prompt_chain(prompt, BS)[:n_full]
            for a in allocs:
                for j, h in enumerate(digests):
                    a.publish(table[j], h)
                a.release(table[:shared], owned=False)
                a.release(table[shared:], owned=True)
                a.unreserve(need)
        _same(*allocs)
    for prompt, table, shared, need, _ in live:
        for a in allocs:
            a.release(table[:shared], owned=False)
            a.release(table[shared:], owned=True)
            a.unreserve(need)
    for a in allocs:
        a.check_drained()
    _same(*allocs)


def test_chain_hash_matches_reference():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1 << 16, 16).astype(np.int32)
    for parent in (0, 7, -(1 << 62)):
        assert port.chain_hash(parent, toks) == ref.chain_hash(parent, toks)
    assert port.blocks_for(0, BS) == 0 and port.blocks_for(9, BS) == 3
