/* Wave replay engine: the host half of the wave fast path
 * (models/wave.py).  Replays the serial pick sequence for a run of K
 * identical pods from the probe's tables (models/probe.py),
 * bit-identically to the device scan / Go reference:
 *
 *   per pick: the max-score fit node set, tie-broken by name-desc order
 *   at index lastNodeIndex % numTies (generic_scheduler.go:119-134
 *   selectHost), then the commit bumps that node's commit count j and
 *   its score moves per the tables.
 *
 * Data structures: nodes live in name-desc position order.  A Fenwick
 * tree holds the CURRENT max-score set (so the r-th tie in name order
 * is an O(log N) order-statistic query); nodes below the max wait in
 * per-score bucket lists (scores are small non-negative ints: sums of
 * 0..10 priority terms times their weights).  Between rebuild events
 * (a normalizer extreme changing: SelectorSpread's maxCount, the
 * NodeAffinity / TaintToleration / InterPod extremes over the live fit
 * set) only the picked node's score changes, so each pick is O(log N);
 * rebuild events trigger an O(N + R) rescore and are rare (maxCount
 * moves once per fill level, fit exits at most N times per run).
 *
 * Score formulas mirror models/replay.py::_scores (which mirrors
 * ops/priorities.py, which mirrors the Go): float32 for spread, double
 * for the normalizers, C-cast truncation toward zero.  The Python spec
 * replay is the differential ground truth (tests/test_wave.py).
 *
 * Build: make -C kubernetes_tpu/native  (produces _replay.so, loaded
 * via ctypes from models/replay.py; a missing lib degrades to the
 * Python spec replay).
 *
 * Copy of kubernetes_tpu/native/replay.c, unchanged; native/build.py of
 * this package builds it.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int64_t i64;
typedef int32_t i32;
typedef uint8_t u8;

/* out_state[4] status values */
#define ST_COMPLETE 0     /* all K pods decided (tail may be unschedulable) */
#define ST_BAIL_HORIZON 1 /* a node hit the table depth: re-probe */
#define ST_BAIL_REBUILDS 2 /* pathological rebuild rate: use the scan */
#define ST_BAIL_BOUNDS 3   /* score left [0, R]: use the spec replay */

typedef struct {
    i32 n;
    i32 *t; /* 1-based Fenwick array of 0/1 membership counts */
    i32 total;
    i32 log2n;
} Fen;

static void fen_reset(Fen *f) {
    memset(f->t, 0, (size_t)(f->n + 1) * sizeof(i32));
    f->total = 0;
}

static void fen_add(Fen *f, i32 pos, i32 delta) { /* pos: 0-based */
    for (i32 i = pos + 1; i <= f->n; i += i & (-i))
        f->t[i] += delta;
    f->total += delta;
}

/* smallest 0-based pos with prefix sum >= k (k >= 1) */
static i32 fen_select(const Fen *f, i32 k) {
    i32 pos = 0;
    for (i32 step = 1 << f->log2n; step; step >>= 1) {
        i32 nxt = pos + step;
        if (nxt <= f->n && f->t[nxt] < k) {
            pos = nxt;
            k -= f->t[nxt];
        }
    }
    return pos;
}

typedef struct {
    i32 N, J;
    const u8 *fit_static;
    const u8 *res_fit; /* J*N */
    const i64 *tab;    /* J*N */
    const i64 *static_add;
    i32 w_sp, has_sel, selfmatch;
    const i64 *spread_base; /* NULL when spread inactive */
    i32 w_na;
    const i64 *na_counts;
    i32 w_tt;
    const i64 *tt_counts;
    i32 w_ip;
    const i64 *ip_totals;
    /* live state */
    i64 *j; /* commit counts per node (the caller's output buffer) */
    u8 *fit;
    /* normalizer extremes over the fit set */
    i64 M, na_max, tt_max, ip_mx, ip_mn;
} Run;

static i64 node_score(const Run *r, i32 n) {
    i64 s = r->tab[(size_t)r->j[n] * r->N + n] + r->static_add[n];
    if (r->spread_base) {
        /* ops/priorities.selector_spread, no-zone branch (float32) */
        float f = 10.0f;
        if (r->has_sel && r->M > 0) {
            i64 c = r->fit[n]
                        ? r->spread_base[n] + (r->selfmatch ? r->j[n] : 0)
                        : 0;
            f = 10.0f * ((float)(r->M - c) / (float)r->M);
        }
        s += (i64)r->w_sp * (i64)f;
    }
    if (r->na_counts) {
        /* ops/priorities.normalize_counts_up (double) */
        i64 v = 0;
        if (r->na_max > 0)
            v = (i64)(10.0 * ((double)r->na_counts[n] / (double)r->na_max));
        s += (i64)r->w_na * v;
    }
    if (r->tt_counts) {
        /* ops/priorities.normalize_counts_down (double) */
        i64 v = 10;
        if (r->tt_max > 0)
            v = (i64)((1.0 - (double)r->tt_counts[n] / (double)r->tt_max) *
                      10.0);
        s += (i64)r->w_tt * v;
    }
    if (r->ip_totals) {
        /* ops/interpod.interpod_normalize (double); unfit nodes are
         * never scored, so the where(fit, ., 0) is implicit */
        i64 rng = r->ip_mx - r->ip_mn;
        i64 v = 0;
        if (rng > 0)
            v = (i64)(10.0 *
                      ((double)(r->ip_totals[n] - r->ip_mn) / (double)rng));
        s += (i64)r->w_ip * v;
    }
    return s;
}

/* the ops reductions use where=fit with initial=0 (spread/na/tt) and
 * the 0-pinned minmax (interpod_minmax) */
static void recompute_extremes(Run *r) {
    i64 M = 0, na = 0, tt = 0, mx = 0, mn = 0;
    int any = 0;
    for (i32 n = 0; n < r->N; n++) {
        if (!r->fit[n])
            continue;
        if (r->spread_base) {
            i64 c = r->spread_base[n] + (r->selfmatch ? r->j[n] : 0);
            if (c > M)
                M = c;
        }
        if (r->na_counts && r->na_counts[n] > na)
            na = r->na_counts[n];
        if (r->tt_counts && r->tt_counts[n] > tt)
            tt = r->tt_counts[n];
        if (r->ip_totals) {
            if (!any || r->ip_totals[n] > mx)
                mx = r->ip_totals[n];
            if (!any || r->ip_totals[n] < mn)
                mn = r->ip_totals[n];
        }
        any = 1;
    }
    if (mx < 0)
        mx = 0;
    if (mn > 0)
        mn = 0;
    r->M = M;
    r->na_max = na;
    r->tt_max = tt;
    r->ip_mx = mx;
    r->ip_mn = mn;
}

/* out_state: [n_picks, L_final, scheduled, rebuilds, status] */
i64 replay_run(i32 N, i32 J, i64 K, i64 L0, const u8 *fit_static,
               const u8 *res_fit, const i64 *tab, const i64 *static_add,
               i32 w_sp, i32 has_sel, i32 selfmatch, const i64 *spread_base,
               i32 w_na, const i64 *na_counts, i32 w_tt, const i64 *tt_counts,
               i32 w_ip, const i64 *ip_totals, i64 score_range,
               i64 rebuild_cap, i32 *chosen, i64 *counts, i64 *out_state) {
    Run r;
    memset(&r, 0, sizeof(r));
    r.N = N;
    r.J = J;
    r.fit_static = fit_static;
    r.res_fit = res_fit;
    r.tab = tab;
    r.static_add = static_add;
    r.w_sp = w_sp;
    r.has_sel = has_sel;
    r.selfmatch = selfmatch;
    r.spread_base = spread_base;
    r.w_na = w_na;
    r.na_counts = na_counts;
    r.w_tt = w_tt;
    r.tt_counts = tt_counts;
    r.w_ip = w_ip;
    r.ip_totals = ip_totals;

    const i64 R = score_range;
    Fen fen;
    fen.n = N;
    fen.log2n = 0;
    while ((1 << (fen.log2n + 1)) <= N)
        fen.log2n++;
    fen.t = calloc((size_t)N + 1, sizeof(i32));
    i32 *head = malloc(((size_t)R + 1) * sizeof(i32));
    i32 *nxt = malloc((size_t)N * sizeof(i32));
    u8 *fit = malloc((size_t)N);
    i64 *score = malloc((size_t)N * sizeof(i64));
    if (!fen.t || !head || !nxt || !fit || !score) {
        free(fen.t);
        free(head);
        free(nxt);
        free(fit);
        free(score);
        return -1;
    }
    r.j = counts;
    memset(counts, 0, (size_t)N * sizeof(i64));
    r.fit = fit;
    for (i32 n = 0; n < N; n++)
        fit[n] = fit_static[n] && res_fit[n]; /* row j=0 */

    i64 smax = -1;
    int have_any = 0;
    i64 rebuilds = -1; /* the initial build is free */
    int status = ST_COMPLETE;

#define REBUILD()                                                            \
    do {                                                                     \
        recompute_extremes(&r);                                              \
        fen_reset(&fen);                                                     \
        for (i64 v = 0; v <= R; v++)                                         \
            head[v] = -1;                                                    \
        smax = -1;                                                           \
        have_any = 0;                                                        \
        for (i32 n = 0; n < N; n++) {                                        \
            if (!fit[n])                                                     \
                continue;                                                    \
            score[n] = node_score(&r, n);                                    \
            if (score[n] < 0 || score[n] > R)                                \
                status = ST_BAIL_BOUNDS;                                     \
            if (score[n] > smax)                                             \
                smax = score[n];                                             \
            have_any = 1;                                                    \
        }                                                                    \
        if (have_any && status == ST_COMPLETE)                               \
            for (i32 n = 0; n < N; n++) {                                    \
                if (!fit[n])                                                 \
                    continue;                                                \
                if (score[n] == smax)                                        \
                    fen_add(&fen, n, 1);                                     \
                else {                                                       \
                    nxt[n] = head[score[n]];                                 \
                    head[score[n]] = n;                                      \
                }                                                            \
            }                                                                \
        rebuilds++;                                                          \
    } while (0)

    REBUILD();

    i64 t = 0, L = L0, scheduled = 0;
    while (t < K && status == ST_COMPLETE) {
        if (!have_any)
            break; /* nothing fits: the rest all fail identically */
        if (fen.total == 0) {
            /* descend to the next occupied bucket */
            i64 v = smax - 1;
            while (v >= 0 && head[v] < 0)
                v--;
            if (v < 0) {
                have_any = 0;
                break;
            }
            smax = v;
            for (i32 n = head[v]; n >= 0;) {
                i32 nx = nxt[n];
                fen_add(&fen, n, 1);
                n = nx;
            }
            head[v] = -1;
            continue;
        }
        i32 cnt = fen.total;
        i32 rsel = (i32)(L % (i64)cnt);
        i32 p = fen_select(&fen, rsel + 1);
        chosen[t] = p;
        t++;
        L++;
        scheduled++;
        r.j[p]++;
        if (r.j[p] >= J) {
            status = ST_BAIL_HORIZON;
            break;
        }
        if (!(fit_static[p] && res_fit[(size_t)r.j[p] * N + p])) {
            /* node left the fit set */
            fen_add(&fen, p, -1);
            fit[p] = 0;
            int need = 0;
            if (r.spread_base && r.has_sel) {
                i64 c = r.spread_base[p] + (r.selfmatch ? r.j[p] : 0);
                if (c >= r.M)
                    need = 1; /* may lower maxCount */
            }
            if (r.na_counts && r.na_counts[p] >= r.na_max)
                need = 1;
            if (r.tt_counts && r.tt_counts[p] >= r.tt_max)
                need = 1;
            if (r.ip_totals &&
                (r.ip_totals[p] >= r.ip_mx || r.ip_totals[p] <= r.ip_mn))
                need = 1;
            if (need) {
                i64 oM = r.M, ona = r.na_max, ott = r.tt_max, omx = r.ip_mx,
                    omn = r.ip_mn;
                recompute_extremes(&r);
                if (r.M != oM || r.na_max != ona || r.tt_max != ott ||
                    r.ip_mx != omx || r.ip_mn != omn) {
                    r.M = oM; r.na_max = ona; r.tt_max = ott;
                    r.ip_mx = omx; r.ip_mn = omn;
                    REBUILD();
                }
            }
        } else {
            /* still fit: did this commit raise SelectorSpread's maxCount? */
            if (r.spread_base && r.has_sel && r.selfmatch &&
                r.spread_base[p] + r.j[p] > r.M) {
                REBUILD();
            } else {
                i64 ns = node_score(&r, p);
                if (ns != score[p]) {
                    if (ns < 0 || ns > R) {
                        status = ST_BAIL_BOUNDS;
                        break;
                    }
                    score[p] = ns;
                    if (ns < smax) {
                        fen_add(&fen, p, -1);
                        nxt[p] = head[ns];
                        head[ns] = p;
                    } else if (ns > smax) {
                        /* an LR plateau + Balanced increase can raise a
                         * score; rare — rebuild restores the invariant */
                        REBUILD();
                    }
                }
            }
        }
        if (rebuilds > rebuild_cap) {
            status = ST_BAIL_REBUILDS;
            break;
        }
    }
#undef REBUILD

    out_state[0] = t;
    out_state[1] = L;
    out_state[2] = scheduled;
    out_state[3] = rebuilds < 0 ? 0 : rebuilds;
    out_state[4] = status;
    free(fen.t);
    free(head);
    free(nxt);
    free(fit);
    free(score);
    return 0;
}
