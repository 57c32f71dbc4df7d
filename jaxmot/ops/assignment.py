"""Min-cost assignment on device: parallel auction inside lax.while_loop.

The reference solves detection↔track association with a sequential
Hungarian/Munkres solver (SURVEY.md §2 row "hungarian") — augmenting paths
are hostile to SIMD (SURVEY.md §7 hard part (a)).  The design
named by BASELINE.json ("on-device auction/LAPJV solve inside
jax.lax.while_loop") is Bertsekas' auction algorithm: every unassigned row
bids in parallel (one [n, n] elementwise block per round), columns take the best
bid, and the prices converge to epsilon-complementary-slackness.

Design notes (measured, see tests/test_assignment.py):
  * The problem is squared to n = max(N, M): exactly enough dummy columns
    exist for auction losers, and the symmetric epsilon-CS optimality bound
    applies (asymmetric auction with stale unassigned-column prices loses
    optimality).
  * Rows with no feasible entry ("dead" track slots / padded detections)
    get benefit 0 everywhere — they become indifferent filler instead of
    drilling price wars down the infeasible penalty pit.
  * A single small epsilon is used instead of epsilon-scaling: scaling's
    later phases degenerate into single-bidder eviction chains re-climbing
    overshot prices (~1-2k sequential rounds); a single phase at
    eps = 0.02 cost units converges in ~15-120 rounds at MOT sizes with
    total cost within n*eps of the Hungarian optimum — far below the IoU
    resolution that MOT association cares about.
  * A row-dependent tie-break jitter (< eps/4) keeps identical rows from
    serializing on the same column.

The exact host-side reference (scipy Hungarian) is `scipy_assign`, used by
the non-jit API and the parity tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Feasible costs are assumed in [0, COST_CAP); infeasible pairs are handled
# via the `feasible` mask (iou.association_cost marks them with 1e4).
COST_CAP = 4.0
_NEG = -8.0          # benefit of an infeasible pair (below the 0 of dummies)
DEFAULT_EPS = 0.02   # auction epsilon in cost units; suboptimality <= n*eps


def auction_assign(cost: jnp.ndarray, feasible: jnp.ndarray,
                   eps: float = DEFAULT_EPS,
                   max_iters: int = 2000) -> jnp.ndarray:
    """Solve min-cost assignment; returns row_to_col [N] int32, -1 = unmatched.

    cost     : [N, M] float32; only entries with feasible=True participate.
    feasible : [N, M] bool.
    Rows/columns whose only options are infeasible come back unmatched.
    Matches scipy_assign's cardinality; total cost within ~n*eps of optimal.
    """
    return auction_assign_stats(cost, feasible, eps, max_iters)[0]


def auction_assign_stats(cost: jnp.ndarray, feasible: jnp.ndarray,
                         eps: float = DEFAULT_EPS, max_iters: int = 2000
                         ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """auction_assign plus observability: returns (row_to_col [N] int32,
    iters [] int32, converged [] bool)."""
    n = max(cost.shape) if cost.size else 0
    out = auction_assign_warm(
        cost, feasible, jnp.zeros((n,), jnp.float32),
        jnp.full((n,), -1, jnp.int32), eps, max_iters)
    return out[0], out[1], out[2]


def build_benefits(cost: jnp.ndarray, feasible: jnp.ndarray,
                   eps: float) -> jnp.ndarray:
    """Squared benefit matrix [n, n] (n = max(N, M)): feasible costs map to benefits in [1, 1+COST_CAP],
    infeasible pairs to _NEG, dead rows to neutral 0 filler, dummies pad
    at 0, and a row/column tie-break jitter << eps is added."""
    n_rows, m_cols = cost.shape
    n = max(n_rows, m_cols)
    b = jnp.where(feasible,
                  jnp.clip(COST_CAP - cost, 0.0, COST_CAP) + 1.0,
                  _NEG)
    row_dead = ~jnp.any(feasible, axis=1)
    b = jnp.where(row_dead[:, None], 0.0, b)               # neutral filler
    b = jnp.pad(b, ((0, n - n_rows), (0, n - m_cols)))     # dummies = 0
    ri = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
    ci = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return b + ((ri * 7 + ci * 13) % 29).astype(jnp.float32) * (
        0.25 * eps / 29.0)


def strip_to_rows(col_of: jnp.ndarray, feasible: jnp.ndarray,
                  n_rows: int, m_cols: int) -> jnp.ndarray:
    """Squared-problem solution [n] → per-row matches [n_rows] (-1 for
    dummy columns / infeasible pairs)."""
    col_of = col_of[:n_rows]
    matched_real = (col_of >= 0) & (col_of < m_cols)
    ok = matched_real & jnp.take_along_axis(
        feasible, jnp.clip(col_of, 0, m_cols - 1)[:, None], axis=1)[:, 0]
    return jnp.where(ok, col_of, -1).astype(jnp.int32)


@functools.partial(jax.jit,
                   static_argnames=("max_iters", "eps", "warm_budget"))
def auction_assign_warm(
        cost: jnp.ndarray, feasible: jnp.ndarray,
        init_prices: jnp.ndarray, init_col_of: jnp.ndarray,
        eps: float = DEFAULT_EPS, max_iters: int = 2000,
        warm_budget: int = 6
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray,
           jnp.ndarray]:
    """Dynamic-auction warm start; returns (row_to_col [N], iters [],
    converged [], prices [n], col_of [n]) with n = max(N, M).

    The tracking-specific accelerator: consecutive MOT frames pose
    near-identical assignment problems.  Carrying only the PRICES is a
    known trap — final auction prices encode post-gap-bid indifference
    (each winner's value sits ~eps below its second best), so an empty
    assignment against stale prices scrambles preferences into eps-step
    price-climbing churn (measured: >2000 rounds where a cold start
    takes 4).  The sound warm start is Bertsekas' dynamic assignment:
    carry the (prices, matching) PAIR, re-validate every carried pair
    against eps-complementary-slackness under the NEW benefits, keep the
    pairs that still satisfy it, and re-auction only the violators.  The
    standard auction invariant (all assigned pairs eps-CS at all times)
    admits any eps-CS partial initial assignment, so the n*eps
    suboptimality bound is unchanged (Bertsekas 1988, Prop. 1).

    The warm phase is BUDGETED (warm_budget active rounds): when the
    carried matching is structurally wrong for the new frame (det-order
    permutation, mass birth/death, an augmenting-path reshuffle), the
    warm state converges by war-of-attrition +eps eviction chains —
    measured >2000 rounds at n=80 where cold takes 4, because every
    carried pair sits AT indifference so no gap-bid can separate the
    contenders.  Rather than pay that, the program resets to the cold
    start (zero prices, empty matching — its first bids are large
    gap-bids that separate instantly) and finishes under max_iters.
    Steady-state frames converge inside the warm budget in 0-2 rounds;
    distress frames cost cold + warm_budget.  Both phases run in one
    jitted program; no host round-trip decides the fallback.

    init_prices [n] float32 and init_col_of [n] int32 (row -> column of
    the carried matching, -1 = none; must be a matching: no column
    repeated) come from a previous call's last two outputs; pass zeros /
    -1 for a cold start (== auction_assign_stats).

    converged=False means the loop hit max_iters with some row still
    unassigned — the returned assignment is partial and the caller should
    count/flag it (the padded square problem always admits a perfect
    matching via the dummy columns, so non-convergence is an iteration
    budget event, never a structural one).

    iters counts ACTIVE Jacobi rounds.  The while_loop runs 3 rounds per
    condition check (loop-sync amortization), so the budget is enforced
    at 3-round granularity: up to max_iters + 2 active rounds can
    execute before the loop observes the limit.
    """
    n_rows, m_cols = cost.shape
    if n_rows == 0 or m_cols == 0:
        return (jnp.full((n_rows,), -1, jnp.int32), jnp.int32(0),
                jnp.bool_(True), jnp.asarray(init_prices, jnp.float32),
                jnp.asarray(init_col_of, jnp.int32))
    n = max(n_rows, m_cols)
    if init_prices.shape != (n,) or init_col_of.shape != (n,):
        raise ValueError(
            f"init_prices/init_col_of must be [{n}] (squared problem "
            f"size), got {init_prices.shape}/{init_col_of.shape}")

    # Benefits incl. the row-dependent tie-breaker << eps (identical
    # rows — dummy/dead blocks — otherwise all bid the same column each
    # round and serialize).
    b = build_benefits(cost, feasible, eps)

    def cond(state):
        _, col_of, _, it = state
        return jnp.any(col_of < 0) & (it < max_iters)

    row_iota = jnp.arange(n, dtype=jnp.int32)
    col_iota2 = jnp.arange(n, dtype=jnp.int32)[None, :]

    def round_(state):
        # Dense-mask formulation: every indexed update below is an [n, n]
        # one-hot compare+select instead of a gather/scatter inside the
        # while_loop.
        prices, col_of, row_of, it = state
        bidding = col_of < 0                           # [n]
        values = b - prices[None, :]                   # [n, n]
        j_star = jnp.argmax(values, axis=1)            # [n]
        m1 = jnp.max(values, axis=1)
        star_mask = col_iota2 == j_star[:, None]       # [n, n]
        m2 = jnp.max(jnp.where(star_mask, -jnp.inf, values), axis=1)
        m2 = jnp.where(jnp.isfinite(m2), m2, m1)       # single-col case
        price_at_star = jnp.max(jnp.where(star_mask, prices[None, :],
                                          -jnp.inf), axis=1)
        bid = price_at_star + (m1 - m2) + eps          # [n]

        # Column-wise best bid (Jacobi auction round).
        bids_mat = jnp.where(star_mask & bidding[:, None],
                             bid[:, None], -jnp.inf)   # [n, n]
        best_bid = jnp.max(bids_mat, axis=0)           # [n]
        winner = jnp.argmax(bids_mat, axis=0).astype(jnp.int32)
        has_bid = jnp.isfinite(best_bid)

        # Evict previous owners of re-auctioned columns (dense mask).
        evicted_row = (has_bid[None, :]
                       & (row_of[None, :] == row_iota[:, None]))  # [n, n]
        was_evicted = jnp.any(evicted_row, axis=1)
        # Install winners: row i wins column j iff winner[j] == i & has_bid.
        win_mask = has_bid[None, :] & (winner[None, :] == row_iota[:, None])
        won_col = jnp.max(jnp.where(win_mask, col_iota2, -1), axis=1)
        col_of = jnp.where(won_col >= 0, won_col,
                           jnp.where(was_evicted, -1, col_of))
        row_of = jnp.where(has_bid, winner, row_of)
        prices = jnp.where(has_bid, best_bid, prices)
        # Count only ACTIVE rounds: the unrolled body may run up to 2
        # no-op rounds after convergence, which must not inflate the
        # reported iteration stat or burn max_iters budget.
        return prices, col_of, row_of, it + jnp.any(bidding).astype(
            jnp.int32)

    def body(state):
        # Several Jacobi rounds per while_loop iteration: typical gated
        # MOT problems converge in 5-15 rounds and the per-round compute
        # is a handful of [n, n] elementwise passes, so the loop-condition sync
        # is a significant fraction of the solve.  A round after
        # convergence is a no-op (no unassigned rows -> no bids), so
        # over-running by <= 2 rounds is harmless.
        for _ in range(3):
            state = round_(state)
        return state

    # NOTE — a structural pre-assignment of the zero-benefit block (rank-
    # pairing dead rows onto dead columns at price 0) was built and
    # measured AGAINST here: whenever the dead-row/dead-column counts
    # mismatch (they almost always do — clutter and padding counts are
    # independent), the leftover dummy's eviction chain walks the parked
    # block ONE bid per round (observed 9-24 rounds where the plain cold
    # start takes 4, because parallel Jacobi bidding resolves the whole
    # indifferent block in 1-2 rounds).  Do not reintroduce it.

    # Re-validate the carried matching against eps-CS under the NEW
    # benefits: keep pair (i, j) iff its value is within eps of row i's
    # best — the exact invariant the auction maintains for its own
    # assignments, so kept pairs are indistinguishable from auction-made
    # ones.  Violators (died tracks, moved targets, newly infeasible
    # pairs) restart unassigned.
    #
    # Crucially, columns OUTSIDE the kept matching have their carried
    # price zeroed before the check.  Initial prices are arbitrary (the
    # bound only needs final eps-CS against the same prices the solve
    # starts from), and a freed column keeping its stale indifference-
    # level price repels exactly the displaced row that should re-claim
    # it — the broken rows then converge by +eps attrition instead of
    # one gap-bid (measured: >2000 rounds).  Zeroing can break further
    # pairs (a zero-priced column may now dominate a neighbour's kept
    # pair), so the keep/zero step is peeled a few fixed passes; the
    # warm-budget fallback below covers any stragglers.
    p_carried = jnp.asarray(init_prices, jnp.float32)
    c0 = jnp.asarray(init_col_of, jnp.int32)
    pair_mask = col_iota2 == c0[:, None]                   # [n, n]
    keep = c0 >= 0
    p0 = p_carried
    for _ in range(3):
        col_kept = jnp.any(pair_mask & keep[:, None], axis=0)  # [n]
        p0 = jnp.where(col_kept, p_carried, 0.0)
        values0 = b - p0[None, :]
        m1_0 = jnp.max(values0, axis=1)
        v_at = jnp.max(jnp.where(pair_mask, values0, -jnp.inf), axis=1)
        keep = keep & (v_at >= m1_0 - eps)
    # p0 stays the vector the LAST keep-check ran against — kept pairs
    # provably satisfy eps-CS w.r.t. the exact prices the solve starts
    # from.  (Columns freed by that final check retain stale prices; the
    # warm budget covers the rare straggler they slow down.)
    col_of0 = jnp.where(keep, c0, -1)
    # row_of: inverse mapping of the kept pairs (dense one-hot max; the
    # carried matching never repeats a column, so at most one row wins).
    keep_mask = pair_mask & keep[:, None]                  # [n, n]
    row_of0 = jnp.max(
        jnp.where(keep_mask,
                  jax.lax.broadcasted_iota(jnp.int32, (n, n), 0),
                  -1), axis=0)                             # [n]

    # Phase 1 — budgeted warm solve from the carried state.
    def warm_cond(state):
        _, col_of, _, it = state
        return jnp.any(col_of < 0) & (it < min(warm_budget, max_iters))

    init = (p0, col_of0, row_of0, jnp.int32(0))
    w_prices, w_col, w_row, w_it = jax.lax.while_loop(warm_cond, body, init)

    # Phase 2 — cold fallback if the warm budget ran out: reset to zero
    # prices / empty matching (keeping the round counter for
    # observability) and run the standard auction.  When phase 1
    # converged this select is an identity and the loop body never runs.
    # The reset only fires when phase 1 actually started from carried
    # pairs — with an empty carry (the cold entry point) phase 1 IS the
    # cold solve and phase 2 simply continues it.
    reset = jnp.any(w_col < 0) & jnp.any(keep)
    st = (jnp.where(reset, jnp.zeros((n,), jnp.float32), w_prices),
          jnp.where(reset, jnp.full((n,), -1, jnp.int32), w_col),
          jnp.where(reset, jnp.full((n,), -1, jnp.int32), w_row),
          w_it)
    prices, col_of, _, iters = jax.lax.while_loop(cond, body, st)
    converged = jnp.all(col_of >= 0)

    # Keep real rows only; strip dummy columns and infeasible matches.
    return (strip_to_rows(col_of, feasible, n_rows, m_cols), iters,
            converged, prices, col_of)


def scipy_assign(cost: np.ndarray, feasible: np.ndarray) -> np.ndarray:
    """Host-side exact reference (scipy Hungarian), same interface."""
    from scipy.optimize import linear_sum_assignment

    n, m = cost.shape
    big = COST_CAP * 10.0
    c = np.where(feasible, cost, big)
    rows, cols = linear_sum_assignment(c)
    out = np.full((n,), -1, np.int32)
    for r, cc in zip(rows, cols):
        if feasible[r, cc]:
            out[r] = cc
    return out


def assignment_cost(cost: np.ndarray, row_to_col: np.ndarray) -> float:
    """Total cost of matched pairs (for optimality comparison in tests)."""
    total = 0.0
    for r, c in enumerate(row_to_col):
        if c >= 0:
            total += float(cost[r, c])
    return total
