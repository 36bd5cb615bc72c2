"""``round_step``'s CUDA algorithm (``csrc/round_step.cu``) emulated on the
CPU, event by event: the round-tagged election (each landed event posts
``(tag << 24) | e`` into its slot's word with a max, the tag one above the
last call's, the words never reset) and the ballot leader (each event
reads its row's words, the slots whose word carries this call's tag are
the row's winners, a winner lands ``[msg | id]``, and the winner in the
row's lowest slot sums every winner's ``a_w (msg - k_old)`` in slot order).

Several consecutive rounds share one word buffer, so every round after the
first finds the words of earlier rounds in the rows it touches; events are
taken in random orders in both launches.  Each round's ``theta``, ``Ke``,
``got_ever`` and ``keep`` are held bit for bit against the plain version
(``kernels.ref.gossip_round_step``).  The ballots come in chunks of as
many slots as the kernel gives an event lanes (8 in the fixed kernels, 32
in the generic one).  A variant that lets earlier rounds'
words count (no tag comparison) fails, so the tags are what keeps it
right.  The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import operator

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _port_session import port_background_jobs  # noqa: E402,F401

from repro_torch.kernels import round_fuse as rf  # noqa: E402
from repro_torch.kernels.ref import gossip_round_step  # noqa: E402

ID_BITS = 24
ID_MASK = (1 << ID_BITS) - 1

# (n, k, p, m events a round, deliver fraction a round, seen fraction):
# a round with deliver fraction 0 delivers nothing
CASES = {
    "duplicates": (20, 5, 8, 60, (0.8, 0.9, 0.7, 0.8), 0.5),
    "first_receipts": (40, 6, 4, 30, (0.9, 0.9, 0.9, 0.9), 0.0),
    "nothing_delivered": (15, 4, 3, 25, (0.8, 0.0, 0.8, 0.8), 0.3),
    "k_over_32": (6, 40, 5, 90, (0.9, 0.8, 0.9, 0.9), 0.5),
    "main_path_shape": (30, 18, 32, 200, (0.9, 0.9, 0.9, 0.9), 0.0),
}


def initial_state(n, k, p, seen, rng):
    Ke = np.concatenate([rng.standard_normal((n * k, p)),
                         np.full((n * k, 1), -1.0)], axis=1)
    return dict(theta=rng.standard_normal((n, p)).astype(np.float32),
                Ke=Ke.astype(np.float32),
                got_ever=rng.uniform(size=n) < seen,
                theta_base=rng.standard_normal((n, p)).astype(np.float32),
                a_w=rng.uniform(0.1, 1.0, n * k).astype(np.float32))


def round_events(n, k, p, m, deliver_frac, rng):
    """One round's operands: targets drawn with replacement (duplicate
    slots, rows with several winners), undelivered events at the
    sentinels."""
    codes = rng.integers(0, n * k, m)
    deliver = rng.uniform(size=m) < deliver_frac
    return dict(msg=rng.standard_normal((m, p)).astype(np.float32),
                tgt_row=np.where(deliver, codes // k, n).astype(np.int32),
                enc=np.where(deliver, codes, n * k).astype(np.int32),
                k_old=rng.standard_normal((m, p)).astype(np.float32))


def group_lanes(k, p):
    """Lanes an event gets: 8 in the fixed kernels (k <= 32, p = 32), a
    warp in the generic one."""
    return 8 if k <= 32 and p == 32 else 32


def ballots(row_words, tag, match, lanes):
    """The row's winner mask, one ballot over ``lanes`` lanes a chunk of
    ``lanes`` slots."""
    hits = 0
    for c0 in range(0, len(row_words), lanes):
        for lane, w in enumerate(row_words[c0:c0 + lanes]):
            if match(w >> ID_BITS, tag):
                hits |= 1 << (c0 + lane)
    return hits


def emulate_round(state, ev, words, rng, match=operator.eq):
    """The kernel's two launches over ``state`` (updated in place) and the
    persistent ``words`` (a list of n*k + 2 ints, updated in place), the
    events of each launch in a random order.  Returns ``keep``."""
    theta, Ke, got_ever = state["theta"], state["Ke"], state["got_ever"]
    theta_base, a_w = state["theta_base"], state["a_w"]
    msg, tgt_row, enc, k_old = ev["msg"], ev["tgt_row"], ev["enc"], \
        ev["k_old"]
    n, p = theta.shape
    nk = Ke.shape[0]
    k = nk // n
    m = msg.shape[0]

    def landed(e):
        return 0 <= enc[e] < nk and tgt_row[e] < n

    # elect: one thread per event, in any order
    tag = words[nk] + 1
    words[nk + 1] = tag
    for e in rng.permutation(m):
        if landed(e):
            s = int(enc[e])
            words[s] = max(words[s], tag << ID_BITS | int(e))
    # apply: one group of lanes per event, in any order
    tag = words[nk + 1]
    words[nk] = tag
    keep = np.zeros(m, bool)
    for e in rng.permutation(m):
        if not landed(e):
            continue
        s = int(enc[e])
        r, mine = divmod(s, k)
        row = words[r * k:(r + 1) * k]
        hits = ballots(row, tag, match, group_lanes(k, p))
        keep[e] = (row[mine] & ID_MASK) == e
        if not keep[e]:
            continue
        Ke[s, :p] = msg[e]
        Ke[s, p] = np.float32(e)
        if (hits & -hits).bit_length() - 1 != mine:
            continue                        # a lower slot's winner leads
        acc = (theta if got_ever[r] else theta_base)[r].copy()
        for q in range(mine, k):
            if hits >> q & 1:
                we = row[q] & ID_MASK
                acc = acc + a_w[r * k + q] * (msg[we] - k_old[we])
        theta[r] = acc
        got_ever[r] = True
    return keep


def run_rounds(case, seed, match=operator.eq):
    """Every round of ``case`` through the emulation on one word buffer,
    beside the plain version on the same round-start state.  Yields
    ``(round, emulated, plain, stats)`` per round."""
    n, k, p, m, fracs, seen = CASES[case]
    rng = np.random.default_rng(seed)
    state = initial_state(n, k, p, seen, rng)
    words = [0] * (n * k + 2)
    for t, frac in enumerate(fracs):
        ev = round_events(n, k, p, m, frac, rng)
        before = {f: state[f].copy() for f in ("theta", "Ke", "got_ever")}
        stale = sum(1 for e in range(m) if ev["tgt_row"][e] < n for w in
                    words[ev["enc"][e] // k * k:(ev["enc"][e] // k + 1) * k]
                    if 0 < w >> ID_BITS <= words[n * k])
        keep = emulate_round(state, ev, words, rng, match)
        want = gossip_round_step(
            *(torch.as_tensor(before[f].copy())
              for f in ("theta", "Ke", "got_ever")),
            *(torch.as_tensor(ev[f]) for f in ("msg", "tgt_row", "enc",
                                               "k_old")),
            torch.as_tensor(state["theta_base"]),
            torch.as_tensor(state["a_w"]))
        got = (state["theta"], state["Ke"], state["got_ever"], keep)
        yield t, got, [w.numpy() for w in want], \
            dict(before=before, ev=ev, stale_words=stale, n=n, k=k)


def same(got, want):
    return all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tagged_election_matches_the_plain_version(case, seed):
    """Every round bit for bit: theta, Ke (with the id column), got_ever
    and keep."""
    for t, got, want, _ in run_rounds(case, seed):
        for name, g, w in zip(("theta", "Ke", "got_ever", "keep"), got,
                              want):
            np.testing.assert_array_equal(g, w, err_msg=f"{name}, round "
                                                        f"{t}")


def test_cases_hit_what_they_name():
    """The rounds hold duplicate targets, rows with several winners, first
    receipts and later ones, a round with nothing delivered, k > 32, and
    (after round 0) words of earlier rounds in the rows they touch."""
    seen = set()
    for case in CASES:
        for t, got, want, st in run_rounds(case, 0):
            n, k, ev, keep = st["n"], st["k"], st["ev"], want[3]
            tgt = ev["enc"][ev["tgt_row"] < n]
            if tgt.size == 0:
                seen.add("nothing_delivered")
                continue
            if np.unique(tgt).size < tgt.size:
                seen.add("duplicate_targets")
            rows, counts = np.unique(ev["enc"][keep] // k, return_counts=True)
            if (counts > 1).any():
                seen.add("several_winners")
            first = ~st["before"]["got_ever"][rows]
            if first.any():
                seen.add("first_receipt")
            if (~first).any():
                seen.add("later_receipt")
            if k > 32:
                seen.add("k_over_32")
            if t > 0 and st["stale_words"] > 0:
                seen.add("earlier_words")
    assert seen == {"nothing_delivered", "duplicate_targets",
                    "several_winners", "first_receipt", "later_receipt",
                    "k_over_32", "earlier_words"}


def test_untagged_words_fail():
    """With the tag comparison dropped (any word ever posted counts as a
    winner), earlier rounds' words join the row sums and the rounds no
    longer match the plain version: the tags carry the correctness."""
    ignore_tag = lambda word_tag, tag: word_tag != 0  # noqa: E731
    for case in ("duplicates", "k_over_32"):
        results = [same(got, want) for _, got, want, _ in
                   run_rounds(case, 0, match=ignore_tag)]
        assert results[0]                   # round 0 has no earlier words
        assert not all(results[1:]), case


def test_round_words_registry():
    """One zeroed (n*k + 2,) int64 buffer per (n*k, device): the same one
    on every call, two sizes kept apart."""
    a = rf.round_words(12, "cpu")
    assert a.dtype == torch.int64 and a.shape == (14,) and not a.any()
    assert rf.round_words(12, torch.device("cpu")) is a
    b = rf.round_words(20, "cpu")
    assert b is not a and b.shape == (22,)
    rf._round_words.clear()
