"""Keyframe place-recognition database: batched BoW scoring over all KFs.

Reference: src/KeyFrameDatabase.cc — inverted file word->KF list (:33-37),
DetectLoopCandidates (:76-197: shared-word prefilter >=0.8*max, L1 BoW
score >= minScore, accumulated score over top-10 covisibles, keep
> 0.75*best), DetectRelocalizationCandidates (:199-309, same without
minScore).

Array-program design: no inverted file. Per-keyframe BoW vectors are
fixed-capacity sparse (word_id, weight) arrays; a query is expanded to a dense
L1-normalized histogram once, and scoring against ALL keyframes is one batched
gather + masked sum (the L1 score 1 - 0.5*|q - v|_1 equals sum_w min(q_w, v_w)
for L1-normalized vectors, so only shared words contribute). This turns the
reference's per-word list-walk into one (K, cap) gather that the compiler tiles
— and it is exact, not an approximation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from c_orb_slam_tpu.bow.vocab import FrameBow, Vocabulary, transform


class SparseBow(NamedTuple):
    """Aggregated tf-idf BoW vector, L1-normalized, fixed capacity."""

    word: np.ndarray  # (cap,) int64, -1 padding
    weight: np.ndarray  # (cap,) float32
    n: int


@functools.partial(jax.jit, static_argnames=("cap",))
def aggregate_bow_dev(word: jnp.ndarray, weight: jnp.ndarray, cap: int):
    """Device-side aggregate_bow: per-descriptor (word, idf) -> sorted
    unique (word, tf*idf) L1-normalized, fixed capacity. Unique words never
    exceed the descriptor count, so cap >= N loses nothing. Runs on device
    so the transform -> aggregate -> score chain needs NO host round trip.
    """
    big = jnp.int32(1 << 30)
    key = jnp.where(word >= 0, word.astype(jnp.int32), big)
    order = jnp.argsort(key)
    w_s = key[order]
    wt_s = weight[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), w_s[1:] != w_s[:-1]]
    ) & (w_s < big)
    gid = jnp.where(
        w_s < big, jnp.cumsum(first.astype(jnp.int32)) - 1, cap
    )
    acc = jax.ops.segment_sum(
        jnp.where(w_s < big, wt_s, 0.0), gid, num_segments=cap + 1
    )[:cap]
    uniq = jnp.full((cap,), big, jnp.int32).at[gid].set(w_s, mode="drop")
    valid = uniq < big
    acc = jnp.where(valid, acc, 0.0)
    acc = acc / jnp.maximum(jnp.sum(acc), 1e-12)
    return jnp.where(valid, uniq, -1), acc


def aggregate_bow(fb: FrameBow, cap: int) -> SparseBow:
    """Per-descriptor (word, idf) -> sorted unique (word, tf*idf), L1-norm
    (reference: BowVector::addWeight + normalize, BowVector.h:56-84)."""
    w = np.asarray(fb.word)
    wt = np.asarray(fb.weight)
    ok = w >= 0
    words, inv = np.unique(w[ok], return_inverse=True)
    acc = np.zeros(len(words), np.float32)
    np.add.at(acc, inv, wt[ok])
    s = acc.sum()
    if s > 0:
        acc /= s
    out_w = np.full(cap, -1, np.int64)
    out_v = np.zeros(cap, np.float32)
    n = min(len(words), cap)
    if len(words) > cap:  # keep the heaviest words
        top = np.argsort(-acc)[:cap]
        top = top[np.argsort(words[top])]
        words, acc = words[top], acc[top]
    out_w[:n] = words[:n]
    out_v[:n] = acc[:n]
    return SparseBow(out_w, out_v, n)


@functools.partial(jax.jit, static_argnames=("n_words",))
def _score_all(
    q_word: jnp.ndarray,
    q_weight: jnp.ndarray,
    kf_word: jnp.ndarray,
    kf_weight: jnp.ndarray,
    kf_valid: jnp.ndarray,
    n_words: int,
):
    """L1 BoW score + shared-word count of the query against every KF."""
    dense = jnp.zeros(n_words + 1, jnp.float32)
    idx = jnp.where(q_word >= 0, q_word, n_words)
    dense = dense.at[idx].add(q_weight)
    dense = dense.at[n_words].set(0.0)
    has = jnp.zeros(n_words + 1, bool).at[idx].set(q_word >= 0)
    has = has.at[n_words].set(False)

    k_idx = jnp.where(kf_word >= 0, kf_word, n_words)
    qv = dense[k_idx]  # (K, cap)
    shared = has[k_idx] & (kf_word >= 0)
    score = jnp.sum(jnp.where(shared, jnp.minimum(qv, kf_weight), 0.0), axis=1)
    n_shared = jnp.sum(shared, axis=1).astype(jnp.int32)
    score = jnp.where(kf_valid, score, -1.0)
    n_shared = jnp.where(kf_valid, n_shared, 0)
    return score, n_shared


@functools.partial(jax.jit, donate_argnums=(0,))
def _set_row(A: jnp.ndarray, i: jnp.ndarray, row: jnp.ndarray) -> jnp.ndarray:
    return A.at[i].set(row)


class KeyFrameDatabase:
    """Per-KF sparse BoW vectors, DEVICE-resident (no upload of the full
    (Nk, cap) tables per query; rows are updated in place with buffer
    donation), + batched device queries."""

    def __init__(self, voc: Vocabulary, max_keyframes: int, cap: int):
        self.voc = voc
        self.cap = cap
        self.word_dev = jnp.full((max_keyframes, cap), -1, jnp.int32)
        self.weight_dev = jnp.zeros((max_keyframes, cap), jnp.float32)
        self.valid = np.zeros(max_keyframes, bool)  # host (tiny)

    def add_dev(self, kf: int, word: jnp.ndarray, weight: jnp.ndarray):
        """word/weight: (cap,) device arrays from aggregate_bow_dev."""
        self.word_dev = _set_row(self.word_dev, jnp.int32(kf), word)
        self.weight_dev = _set_row(self.weight_dev, jnp.int32(kf), weight)
        self.valid[kf] = True

    def add(self, kf: int, bow: SparseBow):
        self.add_dev(
            kf,
            jnp.asarray(bow.word, jnp.int32),
            jnp.asarray(bow.weight, jnp.float32),
        )

    def erase(self, kf: int):
        self.valid[kf] = False

    def scores_dev(self, q_word: jnp.ndarray, q_weight: jnp.ndarray, exclude=()):
        """Device (score, n_shared) over all keyframe slots — no readback;
        callers prefetch and fetch when the latency window has passed."""
        valid = self.valid.copy()
        for k in exclude:
            if k >= 0:
                valid[k] = False
        return _score_all(
            q_word, q_weight, self.word_dev, self.weight_dev,
            jnp.asarray(valid), self.voc.n_words,
        )

    def scores(self, query: SparseBow, exclude=()):
        """(score, n_shared_words) numpy arrays over all keyframe slots."""
        score, n_shared = self.scores_dev(
            jnp.asarray(query.word, jnp.int32),
            jnp.asarray(query.weight, jnp.float32),
            exclude,
        )
        import jax as _jax

        score, n_shared = _jax.device_get((score, n_shared))
        return score, n_shared

    # ------------------------------------------------------------------
    def detect_loop_candidates(
        self, query: SparseBow, min_score: float, connected, mapstate, query_kf: int
    ) -> list[int]:
        exclude = set(connected) | {query_kf}
        score, n_shared = self.scores(query, exclude=exclude)
        return self.detect_loop_candidates_from(
            score, n_shared, min_score, mapstate
        )

    def detect_loop_candidates_from(
        self, score: np.ndarray, n_shared: np.ndarray, min_score: float, mapstate
    ) -> list[int]:
        """Reference: KeyFrameDatabase::DetectLoopCandidates (:76-197).

        score/n_shared: fetched outputs of scores_dev (the query's covisible
        KFs must already be excluded, like the inverted file skips them,
        :93-96). Group score accumulation over each candidate's top-10
        covisibles (:148-173); keep > 0.75 * best (:176-193)."""
        if n_shared.max(initial=0) == 0:
            return []
        min_common = max(0.8 * n_shared.max(), 1.0)
        ok = (n_shared >= min_common) & (score >= min_score)
        cand = np.nonzero(ok)[0]
        if len(cand) == 0:
            return []
        # Accumulate scores over covisibility groups.
        acc_best: dict[int, tuple[float, int]] = {}
        best_acc = 0.0
        for k in cand:
            group = [int(k)] + mapstate.covisible_keyframes(int(k), n=10)
            acc = 0.0
            best_k, best_s = int(k), float(score[k])
            for g in group:
                if g < len(score) and score[g] > 0 and n_shared[g] >= min_common:
                    acc += float(score[g])
                    if float(score[g]) > best_s:
                        best_s, best_k = float(score[g]), g
            acc_best[int(k)] = (acc, best_k)
            best_acc = max(best_acc, acc)
        # Keep every group above 0.5x the best accumulated score, capped
        # at the 6 strongest (reference keeps > 0.75x best, :176-193; the
        # wider funnel is right here because the downstream Sim3 gate is
        # one cheap batched RANSAC per candidate, and on low-texture-
        # variety scenes the true loop group often ranks 2nd-4th behind
        # aliased sectors).
        ranked = sorted(
            acc_best.items(), key=lambda kv: -kv[1][0]
        )
        out = []
        seen = set()
        for k, (acc, best_k) in ranked:
            if acc > 0.5 * best_acc and best_k not in seen and len(out) < 6:
                seen.add(best_k)
                out.append(best_k)
        return out

    def detect_reloc_candidates(self, query: SparseBow, mapstate) -> list[int]:
        """Reference: DetectRelocalizationCandidates (:199-309) — same
        group-accumulation scheme, no minScore floor."""
        score, n_shared = self.scores(query)
        if n_shared.max(initial=0) == 0:
            return []
        min_common = max(0.8 * n_shared.max(), 1.0)
        ok = n_shared >= min_common
        cand = np.nonzero(ok)[0]
        if len(cand) == 0:
            return []
        acc_best: dict[int, tuple[float, int]] = {}
        best_acc = 0.0
        for k in cand:
            group = [int(k)] + mapstate.covisible_keyframes(int(k), n=10)
            acc, best_k, best_s = 0.0, int(k), float(score[k])
            for g in group:
                if g < len(score) and score[g] > 0:
                    acc += float(score[g])
                    if float(score[g]) > best_s:
                        best_s, best_k = float(score[g]), g
            acc_best[int(k)] = (acc, best_k)
            best_acc = max(best_acc, acc)
        out, seen = [], set()
        for k, (acc, best_k) in acc_best.items():
            if acc > 0.75 * best_acc and best_k not in seen:
                seen.add(best_k)
                out.append(best_k)
        return out
