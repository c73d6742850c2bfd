"""Copy of ``flashweave_tpu/learning/scheduler.py`` for the PyTorch port.

The JAX file imports jax directly (its line 262) and through
``..ops.statfuns``.  In this copy the relative imports resolve inside
``flashweave_tpu_torch``, which imports no jax, and the multi-process
clock probe is single-process.  Nothing else differs;
``tests/test_torch_learning.py`` checks that.

Round-based batched scheduler for the HITON searches.

TPU-native replacement for the reference's Distributed master/worker
interleaved backend (reference: src/interleaved.jl + src/stackchannels.jl).
Instead of RemoteChannel job queues with LIFO stealing across worker
processes, ALL target variables advance concurrently in rounds: each round
collects every active target's pending batch of conditional tests and
dispatches them as a single fixed-shape device batch (ops/condtests.py).

Preserved semantics:
- feed-forward: finished targets' neighborhoods whitelist candidates of
  still-running targets (reference: src/interleaved.jl:124-131).  Whitelist
  membership is SNAPSHOTTED at window build (hiton.phase_backend) -- the
  single semantic shared by standard and turbo windows, matching the
  reference's job-start skip_nbrs snapshot at window (vs job) granularity.
- convergence early-stop on the edge-growth rate (reference:
  src/interleaved.jl:203-230).  As in the reference, convergence never
  interrupts a running search pass: it only freezes searches that checkpoint
  at their PER-JOB time limit (src/interleaved.jl:119-124 marks only
  checkpointed results 'C'; fresh jobs always run a full pass).  This also
  makes results machine-speed independent whenever no single pass exceeds
  time_limit.
- time-limit checkpointing into resumable HitonStates; an unconverged
  checkpoint resumes immediately with a fresh clock (the reference requeues
  it and restarts the clock on re-entry, src/hiton.jl:305).

Divergence from the reference (documented): the reference discards a
phase-'I' checkpoint on resume (src/hiton.jl:329-338 returns an empty
stopped state because prepare_interleaving_phase hands an empty candidate
list to the isempty() guard); this implementation resumes from
unchecked_vars as the checkpoint machinery intends.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..types import HitonState, NbrStatDict
from .hiton import HitonConfig, SearchControl, fast_mode, si_hiton_pc_gen


def _scan_digest(stat, df, n_obs, suff, offsets, counts, alpha):
    """Vectorized per-request early-exit/weakest digest over a mega-batch.

    For each request segment [offset, offset+count) computes, with the SAME
    float64 host semantics as the generator's sequential scan
    (hiton.test_subsets_gen):
      exit_e:    local index of the first non-significant test, or -1
      w_loc:     local index of the weakest (max-pval, LAST occurrence on
                 ties) test, or -1; computed only for no-exit segments --
                 an exiting candidate returns its rejection immediately, so
                 its deferred weakest is never consumed
      maxp:      the weakest test's p-value (NaN when w_loc == -1)
      exit_pval: p-value of the exit test (1.0 when exit_e == -1)

    Significance is classified WITHOUT per-element gammaincc: pval < alpha
    <=> |mi|*n_obs > chi2_g_threshold(alpha)[df] (exact p-values are
    recomputed for the vanishingly rare near-threshold elements).  gammaincc
    then runs only over the concatenated early-exit prefixes plus the exit
    elements -- exactly the tests the reference's sequential loop evaluates
    (src/tests.jl:326-336) -- instead of the whole padded mega-batch.
    """
    from ..ops import statfuns as sf

    Btot = len(stat)
    nreq = len(offsets)
    x = np.abs(stat) * n_obs                          # NaN stat -> not sig
    thr = sf.chi2_g_threshold(alpha, int(df.max(initial=0)))
    tv = thr[np.clip(df, 0, None)]
    with np.errstate(invalid="ignore"):
        sig = suff & (x > tv)
        # near-threshold insurance: direct p-value comparison where the
        # scaled statistic sits within fp noise of the inverted threshold
        close = suff & (df > 0) & (np.abs(x - tv) <= 1e-9 * (1.0 + tv))
    if close.any():
        ci = np.nonzero(close)[0]
        sig[ci] = sf.mi_pval(stat[ci], df[ci], n_obs[ci]) < alpha
    nonsig = np.nonzero(~sig)[0]
    pos = np.searchsorted(nonsig, offsets)
    first = np.append(nonsig, Btot)[pos]   # sentinel: no non-sig after offset
    ends = offsets + counts
    exit_e = np.where(first < ends, first - offsets, -1)
    # weakest tracking is consumed only by requests that complete WITHOUT an
    # exit (an exiting candidate returns its rejection immediately and the
    # deferred weakest dies with the generator frame), so it is computed only
    # for exit_e == -1 segments -- where the prefix is the whole segment and
    # every element is significant (df >= 1, suff true)
    w_loc = np.full(nreq, -1, np.int64)
    maxp = np.full(nreq, np.nan)
    noex = np.nonzero(exit_e < 0)[0]
    if noex.size:
        _weakest_digest(stat, df, n_obs, x, offsets, counts, noex, w_loc,
                        maxp)
    # exact p-values at the exit elements (reference semantics: ~suff -> 1.0)
    exit_pval = np.ones(nreq)
    has_exit = np.nonzero(exit_e >= 0)[0]
    if has_exit.size:
        ei = (offsets + exit_e)[has_exit]
        exit_pval[has_exit] = np.where(
            suff[ei], sf.mi_pval(stat[ei], df[ei], n_obs[ei]), 1.0
        )
    return exit_e, w_loc, maxp, exit_pval


def _weakest_digest(stat, df, n_obs, x, offsets, counts, noex, w_loc, maxp):
    """Weakest-significant (max-pval, last-occurrence-on-ties) per no-exit
    segment, writing into w_loc/maxp in place.

    Exploits that the chi2 p-value is strictly decreasing in x = |mi|*n_obs
    for fixed df: the segment max can only be attained at the min-x element
    of one of the segment's (df,) groups, so gammaincc runs once per
    (segment, df) group instead of once per test.  Tie semantics match the
    reference's sequential ``>=`` scan (src/tests.jl:281-346): within a df
    group, ties at min x resolve to the LAST original index (stable sort);
    across groups, bit-equal candidate p-values resolve to the larger index.
    Below ~1e-300 gradual underflow can tie non-candidate elements too, so
    those segments recompute exactly over the full prefix.

    Known (documented) divergence: above the 1e-300 guard, scipy's gammaincc
    can also be fp-FLAT -- a non-candidate element (larger x, same df) lands
    on a bit-equal p-value -- only where dp per ulp-x drops below one ulp-p,
    which for p < alpha requires alpha >~ 0.3.  At realistic alphas
    (0.01-0.05) this cannot occur; if it does, the reference's sequential
    ``>=`` scan would report the larger index (same p-value, different
    stat/df/Zs), while this digest reports the min-x candidate.
    """
    from ..ops import statfuns as sf

    cnt2 = counts[noex].astype(np.int64)
    total2 = int(cnt2.sum())
    if total2 == 0:
        return
    seg_starts2 = np.zeros(len(noex), np.int64)
    np.cumsum(cnt2[:-1], out=seg_starts2[1:])
    rep2 = np.repeat(np.arange(len(noex)), cnt2)      # noex-local segment id
    loc2 = np.arange(total2) - seg_starts2[rep2]      # index within segment
    gidx = loc2 + offsets[noex][rep2]                 # global element index
    x2 = x[gidx]
    df2 = df[gidx]
    order = np.lexsort((x2, df2, rep2))
    rs, ds, xs = rep2[order], df2[order], x2[order]
    loc_s = loc2[order]
    newgrp = np.empty(total2, bool)
    newgrp[0] = True
    newgrp[1:] = (rs[1:] != rs[:-1]) | (ds[1:] != ds[:-1])
    gstart = np.nonzero(newgrp)[0]
    g_df = ds[gstart]
    g_x = xs[gstart]                                  # per-group min x
    pv = _gammaincc(g_df / 2.0, g_x)
    # per-segment max over its groups (each no-exit segment has >= 1 group)
    newreq = np.empty(len(gstart), bool)
    newreq[0] = True
    newreq[1:] = rs[gstart][1:] != rs[gstart][:-1]
    reqgrp_start = np.nonzero(newreq)[0]
    M2 = np.maximum.reduceat(pv, reqgrp_start)
    rrank = np.cumsum(newreq) - 1                     # group -> segment rank
    grp_of = np.cumsum(newgrp) - 1                    # sorted elem -> group
    # last original index among each group's min-x run (stable sort keeps
    # original order, so the run's last sorted element has the max index)
    eq_run = xs == g_x[grp_of]
    cand_last = np.maximum.reduceat(
        np.where(eq_run, np.arange(total2), -1), gstart
    )
    win = pv == M2[rrank]
    wl = np.where(win, loc_s[cand_last], -1)
    w2 = np.maximum.reduceat(wl, reqgrp_start)
    w_loc[noex] = w2
    maxp[noex] = M2
    # underflow guard: exact full-prefix recomputation for ultra-significant
    # segments where denormal p-values can tie beyond the candidate set
    bad = np.nonzero(M2 < 1e-300)[0]
    for r in bad:
        o, b = int(offsets[noex[r]]), int(counts[noex[r]])
        ppv = sf.mi_pval(stat[o : o + b], df[o : o + b], n_obs[o : o + b])
        M = ppv.max()
        w_loc[noex[r]] = b - 1 - int(np.argmax(ppv[::-1] == M))
        maxp[noex[r]] = M


def _gammaincc(a, x):
    from scipy.special import gammaincc

    return gammaincc(a, x)


def _digest_from_pvals(stat, pval, sig, offsets, counts):
    """Per-candidate (exit_e, weakest stat, weakest pval) digest from
    already-computed p-values (continuous tests) -- float64 host semantics
    identical to the generator's sequential scan: exit at the first
    non-significant test; weakest = max pval with LAST-occurrence
    tie-break, consumed only by no-exit candidates (whose tests are then
    all significant, so no NaNs can reach the max)."""
    Btot = len(stat)
    nreq = len(offsets)
    nonsig = np.nonzero(~sig)[0]
    pos = np.searchsorted(nonsig, offsets)
    first = np.append(nonsig, Btot)[pos]
    ends = offsets + counts
    exit_e = np.where(first < ends, first - offsets, -1)
    seg_id = np.repeat(np.arange(nreq), counts)
    M = np.maximum.reduceat(pval, offsets)
    loc = np.arange(Btot) - offsets[seg_id]
    wloc = np.maximum.reduceat(np.where(pval == M[seg_id], loc, -1),
                               offsets)
    gidx = offsets + np.clip(wloc, 0, None)
    wstat = stat[np.clip(gidx, 0, Btot - 1)]
    return exit_e, wstat, M


class LiveWhitelist:
    """Membership view of a target's neighbors among finished targets."""

    def __init__(self, adj: Dict[int, Set[int]], T: int):
        self.adj = adj
        self.T = T

    def __contains__(self, cand: int) -> bool:
        return cand in self.adj.get(self.T, ())

    def live_set(self):
        """The current neighbor set (None/empty when nothing whitelisted) --
        lets hot consume loops hoist the dict lookup out of the scan."""
        return self.adj.get(self.T)


class RoundScheduler:
    def __init__(
        self,
        engine,
        cfg: HitonConfig,
        target_vars: Sequence[int],
        all_univar_nbrs: Dict[int, NbrStatDict],
        feed_forward: bool = True,
        convergence_threshold: float = 0.01,
        conv_check_start: float = 0.1,
        conv_time_step: float = 0.1,
        update_interval: float = 30.0,
        verbose: bool = False,
        sequential: bool = False,
    ):
        self.engine = engine
        self.cfg = cfg
        self.targets = list(target_vars)
        self.univar = all_univar_nbrs
        self.feed_forward = feed_forward
        self.conv_threshold = convergence_threshold
        self.conv_check_start = conv_check_start
        self.conv_time_step = conv_time_step
        self.update_interval = update_interval
        self.verbose = verbose
        self.sequential = sequential
        self.adj: Dict[int, Set[int]] = {}
        self.n_edges = 0
        self.dispatcher = Dispatcher(engine, cfg.alpha, fast=fast_mode(cfg))
        # multi-process determinism: convergence and time-limit decisions
        # must be identical on every process or the shard_map request
        # streams fork and the collectives desync -- rank 0's wall clock is
        # broadcast once per round and governs every clock read
        # single process: the port drives one device (multi-device is
        # ROADMAP queue 1 item 9)
        self._multiproc = False
        # the broadcast ships RELATIVE time: only differences of clock
        # values are ever consumed, and a raw epoch (~1.7e9) canonicalized
        # to float32 under x64-off would quantize to 128-second steps
        self._anchor = time.time()
        self._now_val = 0.0 if self._multiproc else self._anchor

    def _tick(self) -> float:
        """Advance and return the scheduler clock.  Single-process: wall
        time.  Multi-process: rank 0's wall time via one tiny psum (the only
        extra collective per round); all consumers compare differences, so
        rank 0's relative clock serves every process."""
        if self._multiproc:
            from ..parallel.mesh import bcast_scalar_from_rank0

            self._now_val = bcast_scalar_from_rank0(
                self.engine.mesh, time.time() - self._anchor)
        else:
            self._now_val = time.time()
        return self._now_val

    # -- graph tracking (reference: src/interleaved.jl:101-141) -------------

    def _add_edges(self, T: int, nbrs) -> None:
        for nbr in nbrs:
            a = self.adj.setdefault(T, set())
            b = self.adj.setdefault(nbr, set())
            if nbr not in a:
                a.add(nbr)
                b.add(T)
                self.n_edges += 1

    def _print_network_stats(self) -> None:
        # reference: src/misc.jl:187-198
        import warnings

        n_nodes = len(self.adj)
        deg = np.array([len(s) for s in self.adj.values()]) if self.adj else np.zeros(1)
        print(f"Current nodes/edges: {n_nodes} / {self.n_edges}")
        print(
            f"Degree stats: mean {deg.mean():.2f}, median {np.median(deg):.1f}, "
            f"max {int(deg.max())}"
        )
        if np.median(deg) > n_nodes / 4:
            warnings.warn(
                "The network seems unusually dense (current median degree "
                f"{np.median(deg)} across all nodes) which can lead to slow speed."
            )

    # -- driving ------------------------------------------------------------

    def run(self) -> Dict[int, HitonState]:
        control = SearchControl()
        start_time = self._tick()
        if self._multiproc:
            # JobClocks read the round-quantized broadcast value, so every
            # process takes the same checkpoint decisions at the same points
            control.now_fn = lambda: self._now_val
        gens = {}
        for T in self.targets:
            wl = LiveWhitelist(self.adj, T) if self.feed_forward else None
            gens[T] = si_hiton_pc_gen(
                T, self.cfg, self.engine, self.univar[T],
                whitelist=wl, control=control,
            )

        results: Dict[int, HitonState] = {}
        if self.sequential:
            # one target at a time, matching the reference's single-worker
            # interleaved semantics: whitelists grow between jobs, not within
            jobs_total = len(self.targets)
            check_convergence = False
            last_conv_time = 0.0
            last_conv_edges = 0
            for i, T in enumerate(self.targets):
                state = self._drive_single(gens[T])
                if control.converged and state.phase not in ("F", "C"):
                    state = HitonState(
                        "C", state.state_results, state.inter_results,
                        state.unchecked_vars, state.state_rejections,
                    )
                results[T] = state
                self._add_edges(T, state.state_results.keys())
                # convergence between jobs (reference: src/interleaved.jl:203-230)
                if self.conv_threshold != 0.0 and not control.converged:
                    now = time.time()
                    remaining_frac = (jobs_total - i - 1) / max(jobs_total, 1)
                    if not check_convergence and remaining_frac <= self.conv_check_start:
                        check_convergence = True
                        last_conv_time = now - start_time
                        last_conv_edges = self.n_edges
                    elif check_convergence and last_conv_time > 0:
                        delta_time = (now - start_time - last_conv_time) / last_conv_time
                        if delta_time > self.conv_time_step:
                            delta_edges = (
                                (self.n_edges - last_conv_edges) / last_conv_edges
                                if last_conv_edges
                                else 0.0
                            )
                            if delta_edges / delta_time < self.conv_threshold:
                                control.converged = True
                            last_conv_time = now - start_time
                            last_conv_edges = self.n_edges
            return results

        # Round-based concurrent execution, PIPELINED in two half-round
        # batches.  Each round advances every active generator exactly once
        # in the SAME fixed global order as a plain round loop, but the
        # round's device work ships as two contiguous half-batches: while the
        # host advances the first half's generators, the second half's batch
        # from the previous round (already enqueued) executes on device, and
        # vice versa -- host bookkeeping hides under device time.  Because
        # each test's device result is independent of its batch, and the
        # advance order is unchanged, results are BIT-IDENTICAL to the
        # unpipelined round loop.
        active = {T: gens[T] for T in self.targets}
        first_half = set(self.targets[: (len(self.targets) + 1) // 2])
        resp: Dict[int, object] = {}
        inflight: List[Optional[tuple]] = [None, None]
        jobs_total = len(self.targets)
        check_convergence = False
        converged = False
        last_conv_time = 0.0
        last_conv_edges = 0
        last_update = start_time

        def advance(targets_now):
            pending = {}
            for T in targets_now:
                gen = active[T]
                try:
                    req = gen.send(resp.pop(T, None))
                    pending[T] = req
                except StopIteration as stop:
                    state = stop.value
                    if converged and state.phase not in ("F", "C"):
                        state = HitonState(
                            "C", state.state_results, state.inter_results,
                            state.unchecked_vars, state.state_rejections,
                        )
                    results[T] = state
                    self._add_edges(T, state.state_results.keys())
                    del active[T]
            return pending

        while active or inflight[0] is not None or inflight[1] is not None:
            for ci in (0, 1):
                if inflight[ci] is not None:
                    self._dispatch_finish(inflight[ci], resp)
                    inflight[ci] = None
                in_half = (ci == 0)
                targets_now = [
                    T for T in active if (T in first_half) == in_half
                ]
                pending = advance(targets_now)
                if pending:
                    inflight[ci] = self._dispatch_begin(pending)

            now = self._tick()
            if self.verbose and now - last_update > self.update_interval:
                done = jobs_total - len(active)
                print(
                    f"Time passed: {int(round(now - start_time))}. "
                    f"Finished nodes: {done}. Remaining nodes: {len(active)}"
                )
                self._print_network_stats()
                last_update = now

            # convergence check (reference: src/interleaved.jl:203-230)
            if self.conv_threshold != 0.0 and not converged:
                remaining_frac = len(active) / max(jobs_total, 1)
                if not check_convergence and remaining_frac <= self.conv_check_start:
                    check_convergence = True
                    last_conv_time = now - start_time
                    last_conv_edges = self.n_edges
                    if self.verbose:
                        print(f"Starting convergence checks at {last_conv_edges} edges.")
                elif check_convergence and last_conv_time > 0:
                    delta_time = (now - start_time - last_conv_time) / last_conv_time
                    if delta_time > self.conv_time_step:
                        delta_edges = (
                            (self.n_edges - last_conv_edges) / last_conv_edges
                            if last_conv_edges
                            else 0.0
                        )
                        conv_level = delta_edges / delta_time
                        if conv_level < self.conv_threshold:
                            converged = True
                            control.converged = True
                            if self.verbose:
                                print("\tCONVERGED! Finishing current loads.")
                        last_conv_time = now - start_time
                        last_conv_edges = self.n_edges

        return results

    def _drive_single(self, gen) -> HitonState:
        """Run one generator to completion, dispatching its requests solo
        (exact reference 'single' semantics, still device-batched per chunk)."""
        resp = None
        while True:
            try:
                req = gen.send(resp)
            except StopIteration as stop:
                return stop.value
            resp = self._dispatch_one(req)

    # -- request dispatch ----------------------------------------------------

    def _dispatch_one(self, req):
        return self.dispatcher.one(req)

    def _dispatch_begin(self, pending: Dict[int, tuple]):
        return self.dispatcher.begin(pending)

    def _dispatch_finish(self, bundle, responses: Dict[int, object]):
        return self.dispatcher.finish(bundle, responses)


def _assemble_round(wins):
    """Flatten a round's windows into one (X, Y, Zs, kvec, counts) batch
    with O(groups) numpy calls, NOT O(windows) tile/repeat calls.

    Each entry is (T, cands, Zdata, kdata, counts):
      shared window     -- counts None: Zdata/kdata are the subset TEMPLATE
                           shared by every candidate (tiled here via one
                           grouped fancy-index per distinct (Bc, w) shape)
      pre-concatenated  -- counts is the per-candidate subset-count array and
                           Zdata/kdata already hold all candidates' rows
    Returns the batch plus the flat per-candidate counts; caller slots must
    be reordered with the emitted `order` (the function REORDERS windows so
    same-shape shared windows are contiguous)."""
    ns_idx = [i for i, w in enumerate(wins) if w[4] is not None]
    groups: Dict[tuple, list] = {}
    for i, w in enumerate(wins):
        if w[4] is None:
            groups.setdefault((len(w[3]), len(w[1])), []).append(i)
    order = ns_idx + [i for g in groups.values() for i in g]
    import itertools as _it

    Zcat = np.concatenate([wins[i][2] for i in order])
    kcat = np.concatenate([wins[i][3] for i in order])
    sizes = np.fromiter((len(wins[i][3]) for i in order), np.int64,
                        count=len(order))
    offs = np.zeros(len(order), np.int64)
    np.cumsum(sizes[:-1], out=offs[1:])
    # flat row-gather index: nonshared prefix is the identity, each shared
    # group tiles its template rows w times via one broadcasted add
    idx_parts = [np.arange(int(sizes[:len(ns_idx)].sum()), dtype=np.int64)]
    gi = len(ns_idx)
    counts_parts = [np.asarray(wins[i][4], np.int64) for i in ns_idx]
    for (Bc, w), idxs in groups.items():
        nwin = len(idxs)
        tile_pat = np.tile(np.arange(Bc, dtype=np.int64), w)
        idx_parts.append(
            (offs[gi:gi + nwin, None] + tile_pat[None, :]).ravel())
        counts_parts.append(np.full(nwin * w, Bc, np.int64))
        gi += nwin
    idx = np.concatenate(idx_parts) if len(idx_parts) > 1 else idx_parts[0]
    counts = np.concatenate(counts_parts)
    Zs = Zcat[idx]
    ks = kcat[idx]
    # per-window flat sizes in emit order (shared: w*Bc)
    Bw = np.fromiter(
        (len(wins[i][3]) if wins[i][4] is not None
         else len(wins[i][3]) * len(wins[i][1]) for i in order),
        np.int64, count=len(order))
    Ts = np.fromiter((wins[i][0] for i in order), np.int64, count=len(order))
    X = np.repeat(Ts, Bw).astype(np.int32)
    cand_cat = np.fromiter(
        _it.chain.from_iterable(wins[i][1] for i in order), np.int64,
        count=int(sum(len(wins[i][1]) for i in order)))
    Y = np.repeat(cand_cat, counts).astype(np.int32)
    return X, Y, Zs, ks, counts, order


class Dispatcher:
    """Batches HITON test requests (bare + speculative-window kinds) into
    single async device calls and scatters responses with per-candidate
    digests.  Shared by the round scheduler and the standalone si_hiton_pc
    driver."""

    def __init__(self, engine, alpha: float, fast: bool = False):
        self.engine = engine
        self.alpha = alpha
        # fast mode (hiton.fast_mode): speculative windows consume bare
        # decisions, so miwin responses are minimal per-candidate digests
        # (exit index, weakest stat, weakest pval) -- computed ON DEVICE
        # when the engine supports it, else from the host digest
        self.fast = fast

    def one(self, req):
        kind = req[0]
        if kind == "mi":
            _, T, cand, Zs, kvec = req
            B = len(kvec)
            return self.engine.mi_tests_raw(
                np.full(B, T, np.int32), np.full(B, cand, np.int32), Zs, kvec)
        if kind == "mcor":
            _, pair, var_list = req
            return self.engine.masked_cor([pair], [var_list])[0]
        if kind == "fz":
            _, T, cand, Zs, kvec = req
            B = len(kvec)
            return self.engine.fz_tests_raw(
                np.full(B, T, np.int32), np.full(B, cand, np.int32), Zs, kvec)
        if kind in ("miwin", "mcorwin", "fzwin", "turbowin"):
            # a speculative window still ships as ONE device round in
            # sequential mode -- reuse the batching machinery solo
            resp: Dict[int, object] = {}
            self.finish(self.begin({req[1]: req}), resp)
            return resp[req[1]]
        raise ValueError(f"unknown request kind {kind}")

    def begin(self, pending: Dict[int, tuple]):
        """Batch same-kind requests from all targets and LAUNCH them as
        single async device calls; returns a bundle for _dispatch_finish.

        Request kinds: bare ("mi", T, cand, Zarr, kvec) / ("mcor", pair,
        var_list) from the chunked generator path, and the speculative
        windows ("miwin", T, cands, Zarr, kvec, counts, shared) /
        ("mcorwin", T, pairs, var_lists) carrying a whole window's
        candidates.  Shared windows ship their subset TEMPLATE un-tiled; the
        whole round's flat (X, Y, Zs, kvec) batch is assembled with a
        handful of vectorized numpy passes (_assemble_round) instead of
        per-window tile/repeat calls."""
        mi_win, mi_slots = [], []     # (T, cands, Zdata, kdata, counts|None)
        mi_bare, mi_bare_slots = [], []   # legacy chunked "mi" requests
        fz_win, fz_slots = [], []
        mcor_pairs, mcor_vls = [], []
        mcor_slots = []   # (T, kind, n_cands)
        mcw_win, mcw_slots, mcw_vls = [], [], []  # fast fz_nz windows
        turbo_by_m: Dict[int, tuple] = {}  # m -> ([T], [cands])
        for T, r in pending.items():
            kind = r[0]
            if kind == "turbowin":
                _, _, cands, m = r
                ts, cs = turbo_by_m.setdefault(m, ([], []))
                ts.append(T)
                cs.append(cands)
                continue
            if kind == "mcorwin" and len(r) == 7:
                # fast fz_nz window: positions template(s) + per-candidate
                # mcor var-lists; digested round-level in _finish_mcw
                _, _, cands, varlists, posa, kv, counts = r
                mcw_win.append((T, cands, posa, kv, counts))
                mcw_vls.append(varlists)
                mcw_slots.append((T, len(cands)))
                continue
            if kind in ("mi", "fz"):
                _, _, cand, Zarr, kvec = r
                # bare "mi" requests need full packed results (the chunked
                # generator consumes stats directly), so they dispatch
                # SEPARATELY from the digest-eligible windows -- one legacy
                # request must not force the whole round off the on-device
                # digest path
                win, slots = (mi_bare, mi_bare_slots) if kind == "mi" else (
                    fz_win, fz_slots)
                win.append((T, (cand,), Zarr, kvec, None))
                slots.append((T, kind, 1))
            elif kind in ("miwin", "fzwin"):
                _, _, cands, Zarr, kvec, counts, shared = r
                win, slots = (mi_win, mi_slots) if kind == "miwin" else (
                    fz_win, fz_slots)
                win.append((T, cands, Zarr, kvec,
                            None if shared else counts))
                slots.append((T, kind, len(cands)))
            elif kind == "mcor":
                mcor_pairs.append(r[1])
                mcor_vls.append(r[2])
                mcor_slots.append((T, "mcor", 1))
            elif kind == "mcorwin":
                mcor_pairs.extend(r[2])
                mcor_vls.extend(r[3])
                mcor_slots.append((T, "mcorwin", len(r[2])))
            else:
                raise ValueError(f"unknown request kind {kind}")

        mi_h = None
        dev_digest = (self.fast and mi_win
                      and getattr(self.engine, "dev_digest", False))
        if mi_win:
            Xs, Ys, Zs, ks, counts, order = _assemble_round(mi_win)
            mi_slots = [mi_slots[i] for i in order]
            if dev_digest:
                handle = self.engine.mi_tests_begin_digest(
                    Xs, Ys, Zs, ks, counts, self.alpha)
            else:
                handle = self.engine.mi_tests_begin(Xs, Ys, Zs, ks)
            mi_h = (handle, mi_slots, counts, dev_digest)
        mi_bare_h = None
        if mi_bare:
            Xs, Ys, Zs, ks, counts, order = _assemble_round(mi_bare)
            mi_bare_slots = [mi_bare_slots[i] for i in order]
            mi_bare_h = (self.engine.mi_tests_begin(Xs, Ys, Zs, ks),
                         mi_bare_slots, counts, False)
        fz_h = None
        if fz_win:
            Xs, Ys, Zs, ks, counts, order = _assemble_round(fz_win)
            fz_slots = [fz_slots[i] for i in order]
            fz_h = (self.engine.fz_tests_begin(Xs, Ys, Zs, ks), fz_slots,
                    counts)
        mcor_h = None
        if mcor_pairs:
            mcor_h = (self.engine.masked_cor_begin(mcor_pairs, mcor_vls),
                      mcor_slots)
        mcw_h = None
        if mcw_win:
            Xs, Ys, POS, KV, counts, order = _assemble_round(mcw_win)
            mcw_slots = [mcw_slots[i] for i in order]
            pairs_flat, vls_flat = [], []
            for i in order:
                T_i, cands_i = mcw_win[i][0], mcw_win[i][1]
                pairs_flat.extend((T_i, c) for c in cands_i)
                vls_flat.extend(mcw_vls[i])
            if getattr(self.engine, "cont_dev", False):
                # device window digest: correlations + pcor DP + decision
                # all stay on device; only (3, NC) scalars are fetched
                mcw_h = ("dev",
                         self.engine.cont_tests_begin(vls_flat, POS, KV,
                                                      counts, self.alpha),
                         mcw_slots)
            else:
                from ..ops import condtests as ct

                ct.N_TESTS_DISPATCHED += len(KV)
                mcw_h = ("host",
                         self.engine.masked_cor_begin(
                             pairs_flat, vls_flat,
                             plain=not self.engine.nz),
                         mcw_slots, POS, KV, counts)
        turbo_h = []
        if turbo_by_m:
            from .hiton import _turbo_mxu_template

            for m in sorted(turbo_by_m):
                ts, cs = turbo_by_m[m]
                tpl = _turbo_mxu_template(m, self.engine.max_k)
                h = self.engine.turbo_tests_begin(
                    m, np.asarray(ts, np.int64),
                    np.asarray(cs, np.int64), self.alpha, tpl)
                turbo_h.append((h, ts))
        return (mi_h, mi_bare_h), fz_h, mcor_h, turbo_h, mcw_h

    def finish(self, bundle, responses: Dict[int, object]):
        """Block on a begin() bundle and scatter per-window result
        views, each with precomputed per-candidate early-exit/weakest
        digests."""
        (mi_h, mi_bare_h), fz_h, mcor_h, turbo_h, mcw_h = bundle
        for mi_h in (mi_h, mi_bare_h):
            self._finish_mi(mi_h, responses)
        self._finish_fz_mcor(fz_h, mcor_h, responses)
        self._finish_mcw(mcw_h, responses)
        for h, ts in turbo_h:
            exit_e, wstat, wpval = self.engine.turbo_tests_finish(h)
            for i, T in enumerate(ts):
                responses[T] = (exit_e[i], wstat[i], wpval[i])

    def _finish_mcw(self, mcw_h, responses: Dict[int, object]):
        """Round-level digest of the fast fz_nz windows: extract every
        test's (m, m) submatrix from its candidate's masked correlation,
        run ONE vectorized float64 pcor DP + Fisher-z pass over the whole
        round, and reduce to per-candidate digests -- semantics identical
        to the per-candidate generator scan (hiton.test_subsets_gen with
        _fznz_subset_stats), at a handful of numpy passes per round."""
        if mcw_h is None:
            return
        from ..ops import statfuns as sf

        if mcw_h[0] == "dev":
            _, handles, slots = mcw_h
            exit_e, wstat, wpval = self.engine.cont_tests_finish(handles)
            ri = 0
            for T, w in slots:
                responses[T] = (exit_e[ri:ri + w], wstat[ri:ri + w],
                                wpval[ri:ri + w])
                ri += w
            return
        _, handles, slots, POS, KV, counts = mcw_h
        C_all, nobs = self.engine.masked_cor_finish_raw(handles)
        max_k = self.engine.max_k
        Bt = len(KV)
        offsets = np.zeros(len(counts), np.int64)
        np.cumsum(counts[:-1], out=offsets[1:])
        ti = np.repeat(np.arange(len(nobs)), counts)
        POS = np.asarray(POS, np.int64)
        KV = np.asarray(KV, np.int64)
        pad = np.where(np.arange(max_k)[None, :] < KV[:, None],
                       POS[:, :max_k] + 2, 0)
        idx = np.concatenate(
            [np.zeros((Bt, 1), np.int64), np.ones((Bt, 1), np.int64), pad],
            axis=1)
        stat = np.empty(Bt)
        CH = 1 << 20                   # bound the (CH, m, m) extraction
        for s in range(0, Bt, CH):
            sl = slice(s, min(s + CH, Bt))
            sub = C_all[ti[sl, None, None], idx[sl][:, :, None],
                        idx[sl][:, None, :]]
            stat[sl] = sf.pcor_dp(sub, KV[sl], max_k, xp=np)
        nt = nobs[ti]
        pval = np.asarray(sf.fz_pval(stat, nt, 0))
        sig = (pval < self.alpha) & (nt >= self.engine.n_obs_min)
        exit_e, wstat, wpval = _digest_from_pvals(stat, pval, sig, offsets,
                                                  counts)
        ri = 0
        for T, w in slots:
            responses[T] = (exit_e[ri:ri + w], wstat[ri:ri + w],
                            wpval[ri:ri + w])
            ri += w

    def _finish_mi(self, mi_h, responses: Dict[int, object]):
        if mi_h is not None and mi_h[3]:
            # on-device digest: one tiny fetch of per-candidate decisions
            handle, mi_slots, counts, _ = mi_h
            exit_e, wstat, wpval = self.engine.mi_tests_finish_digest(handle)
            ri = 0
            for T, kind, w in mi_slots:
                responses[T] = (exit_e[ri:ri + w], wstat[ri:ri + w],
                                wpval[ri:ri + w])
                ri += w
        elif mi_h is not None:
            handle, mi_slots, counts, _ = mi_h
            stat, df, n_obs, suff = self.engine.mi_tests_finish_lazy(handle)
            offsets = np.zeros(len(counts), np.int64)
            np.cumsum(counts[:-1], out=offsets[1:])
            exit_e, w_loc, maxp, epv = _scan_digest(
                stat, df, n_obs, suff, offsets, counts, self.alpha)
            if self.fast:
                # minimal per-candidate digests for the superfast consume
                wstat = stat[offsets + np.clip(w_loc, 0, None)]
            ri = 0                      # digest row cursor
            for T, kind, w in mi_slots:
                e0 = int(offsets[ri])
                e1 = (int(offsets[ri + w - 1] + counts[ri + w - 1]))
                if kind == "mi":
                    responses[T] = (stat[e0:e1], df[e0:e1], n_obs[e0:e1],
                                    suff[e0:e1],
                                    (exit_e[ri], w_loc[ri], maxp[ri],
                                     epv[ri]))
                elif self.fast:
                    responses[T] = (exit_e[ri:ri + w], wstat[ri:ri + w],
                                    maxp[ri:ri + w])
                else:
                    responses[T] = (stat[e0:e1], df[e0:e1], n_obs[e0:e1],
                                    suff[e0:e1], offsets[ri:ri + w] - e0,
                                    exit_e[ri:ri + w], w_loc[ri:ri + w],
                                    maxp[ri:ri + w], epv[ri:ri + w])
                ri += w

    def _finish_fz_mcor(self, fz_h, mcor_h, responses: Dict[int, object]):
        if fz_h is not None:
            handle, fz_slots, counts = fz_h
            stat, pval, df, suff = self.engine.fz_tests_finish(handle)
            offsets = np.zeros(len(counts), np.int64)
            np.cumsum(counts[:-1], out=offsets[1:])
            if self.fast:
                # per-candidate digests for the fast consume (float64 host
                # semantics; bare "fz" slots below still get full arrays)
                sig = (pval < self.alpha) & suff
                exit_e, wstat, wpval = _digest_from_pvals(
                    stat, pval, sig, offsets, counts)
            ri = 0
            for T, kind, w in fz_slots:
                e0 = int(offsets[ri])
                e1 = int(offsets[ri + w - 1] + counts[ri + w - 1])
                if kind == "fz":
                    responses[T] = (stat[e0:e1], pval[e0:e1], df[e0:e1],
                                    suff[e0:e1])
                elif self.fast:
                    responses[T] = (exit_e[ri:ri + w], wstat[ri:ri + w],
                                    wpval[ri:ri + w])
                else:
                    responses[T] = (stat[e0:e1], pval[e0:e1], df[e0:e1],
                                    suff[e0:e1], offsets[ri:ri + w] - e0)
                ri += w
        if mcor_h is not None:
            handles, mcor_slots = mcor_h
            outs = self.engine.masked_cor_finish(handles)
            oi = 0
            for T, kind, w in mcor_slots:
                if kind == "mcor":
                    responses[T] = outs[oi]
                else:
                    responses[T] = outs[oi:oi + w]
                oi += w
