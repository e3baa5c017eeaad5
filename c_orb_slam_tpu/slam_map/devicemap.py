"""Device-resident mirror of the map arrays the hot paths consume.

The reference's map lives in shared memory, so "reading the map" from the
tracking thread is free (src/Map.cc, KeyFrame.cc accessors). Here the map
is owned by the host (slam_map/mapstate.py) but consumed by device
programs; before this mirror existed, every tracked frame re-uploaded
~0.5 MB of gathered point rows and every mapping dispatch ~3 MB of
keyframe rows, a dozen latency-bound host->device transfer calls per
frame.

Design: full-capacity point/keyframe arrays live on device; host
mutations mark rows dirty; `flush()` uploads only the dirty rows in ONE
batched transfer and applies them with a jitted scatter (fixed bucket
sizes so the scatter compiles once per bucket). Device programs then
gather rows by index from the resident arrays — the per-frame upload
shrinks to a few KB of indices.

Dirty marking is deliberately a SUPERSET of actual changes (callers mark
whole index batches); correctness only needs marks to cover writes.
tests/test_devicemap.py cross-checks mirror == host after full runs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Scatter bucket sizes: dirty rows are padded up to the next bucket so the
# jitted scatter compiles once per bucket, not once per distinct count.
_PT_BUCKETS = (512, 2048, 8192)
_KF_POSE_BUCKETS = (64,)


@functools.partial(jax.jit, donate_argnums=0)
def _scatter_points(arrs, idx, xyz, normal, mind, maxd, desc, valid):
    PT_xyz, PT_normal, PT_mind, PT_maxd, PT_desc, PT_valid = arrs
    return (
        PT_xyz.at[idx].set(xyz, mode="drop"),
        PT_normal.at[idx].set(normal, mode="drop"),
        PT_mind.at[idx].set(mind, mode="drop"),
        PT_maxd.at[idx].set(maxd, mode="drop"),
        PT_desc.at[idx].set(desc, mode="drop"),
        PT_valid.at[idx].set(valid, mode="drop"),
    )


@functools.partial(jax.jit, donate_argnums=0)
def _scatter_kf_pose(poses, idx, rows):
    return poses.at[idx].set(rows, mode="drop")


@functools.partial(jax.jit, donate_argnums=0)
def _set_kf_row(arrs, k, xy, octave, angle, desc, kp_valid):
    KF_xy, KF_octave, KF_angle, KF_desc, KF_kp_valid = arrs
    return (
        KF_xy.at[k].set(xy),
        KF_octave.at[k].set(octave),
        KF_angle.at[k].set(angle),
        KF_desc.at[k].set(desc),
        KF_kp_valid.at[k].set(kp_valid),
    )


class DeviceMap:
    """Mirror of MapState's point columns + keyframe feature columns.

    Host bookkeeping stays numpy; this class only moves rows host->device.
    Access the arrays after calling flush().
    """

    def __init__(self, ms):
        self.ms = ms
        Np = ms.pt_xyz.shape[0]
        Nk, Kp = ms.kf_desc.shape[:2]
        # Device arrays materialize lazily (jnp.zeros allocates on device,
        # no transfer). Existing host content is marked dirty below.
        self.pt_xyz = jnp.zeros((Np, 3), jnp.float32)
        self.pt_normal = jnp.zeros((Np, 3), jnp.float32)
        self.pt_min_dist = jnp.zeros((Np,), jnp.float32)
        self.pt_max_dist = jnp.zeros((Np,), jnp.float32)
        self.pt_desc = jnp.zeros((Np, 8), jnp.uint32)
        self.pt_valid = jnp.zeros((Np,), bool)
        self.kf_xy = jnp.zeros((Nk, Kp, 2), jnp.float32)
        self.kf_octave = jnp.zeros((Nk, Kp), jnp.int32)
        self.kf_angle = jnp.zeros((Nk, Kp), jnp.float32)
        self.kf_desc = jnp.zeros((Nk, Kp, 8), jnp.uint32)
        self.kf_kp_valid = jnp.zeros((Nk, Kp), bool)
        self.kf_pose = jnp.zeros((Nk, 3, 4), jnp.float32)

        self._pt_dirty = np.zeros(Np, bool)
        self._kf_pose_dirty = np.zeros(Nk, bool)
        self._kf_content_pending: list[int] = []
        # Adopt whatever the host map already holds (nonempty for
        # from_saved_map / mid-run adoption).
        if ms.pt_valid.any():
            self._pt_dirty[ms.pt_valid] = True
        if ms.n_keyframes:
            self._kf_pose_dirty[: ms.n_keyframes] = True
            self._kf_content_pending.extend(range(ms.n_keyframes))

    # -- dirty marking (host side, cheap) --------------------------------
    def mark_points(self, idx):
        self._pt_dirty[idx] = True

    def mark_kf_pose(self, idx):
        self._kf_pose_dirty[idx] = True

    def mark_kf_content(self, k: int):
        self._kf_content_pending.append(int(k))

    # -- flush ------------------------------------------------------------
    def _bucket(self, n: int, buckets, cap: int) -> int:
        for b in buckets:
            if n <= b:
                return b
        return cap

    def flush(self):
        """Upload all dirty rows; one batched transfer per group."""
        ms = self.ms
        # Keyframe content rows (write-once per keyframe).
        for k in self._kf_content_pending:
            args = jax.device_put(
                (
                    np.int32(k),
                    ms.kf_xy[k],
                    ms.kf_octave[k],
                    ms.kf_angle[k],
                    ms.kf_desc[k],
                    ms.kf_kp_valid[k],
                )
            )
            (self.kf_xy, self.kf_octave, self.kf_angle, self.kf_desc,
             self.kf_kp_valid) = _set_kf_row(
                (self.kf_xy, self.kf_octave, self.kf_angle, self.kf_desc,
                 self.kf_kp_valid),
                *args,
            )
        self._kf_content_pending.clear()

        # Point rows.
        n_dirty = int(self._pt_dirty.sum())
        if n_dirty:
            Np = ms.pt_xyz.shape[0]
            if n_dirty > _PT_BUCKETS[-1]:
                arrs = jax.device_put(
                    (ms.pt_xyz, ms.pt_normal, ms.pt_min_dist,
                     ms.pt_max_dist, ms.pt_desc, ms.pt_valid)
                )
                (self.pt_xyz, self.pt_normal, self.pt_min_dist,
                 self.pt_max_dist, self.pt_desc, self.pt_valid) = arrs
            else:
                idx = np.nonzero(self._pt_dirty)[0]
                b = self._bucket(n_dirty, _PT_BUCKETS, Np)
                pad = np.full(b, Np, np.int32)  # out of range -> drop
                pad[:n_dirty] = idx
                safe = np.minimum(pad, Np - 1)
                args = jax.device_put(
                    (
                        pad,
                        ms.pt_xyz[safe],
                        ms.pt_normal[safe],
                        ms.pt_min_dist[safe],
                        ms.pt_max_dist[safe],
                        ms.pt_desc[safe],
                        ms.pt_valid[safe],
                    )
                )
                (self.pt_xyz, self.pt_normal, self.pt_min_dist,
                 self.pt_max_dist, self.pt_desc, self.pt_valid) = (
                    _scatter_points(
                        (self.pt_xyz, self.pt_normal, self.pt_min_dist,
                         self.pt_max_dist, self.pt_desc, self.pt_valid),
                        *args,
                    )
                )
            self._pt_dirty[:] = False

        # Keyframe poses.
        n_dirty = int(self._kf_pose_dirty.sum())
        if n_dirty:
            Nk = ms.kf_pose.shape[0]
            if n_dirty > _KF_POSE_BUCKETS[-1]:
                self.kf_pose = jax.device_put(ms.kf_pose)
            else:
                idx = np.nonzero(self._kf_pose_dirty)[0]
                b = self._bucket(n_dirty, _KF_POSE_BUCKETS, Nk)
                pad = np.full(b, Nk, np.int32)
                pad[:n_dirty] = idx
                safe = np.minimum(pad, Nk - 1)
                args = jax.device_put((pad, ms.kf_pose[safe]))
                self.kf_pose = _scatter_kf_pose(self.kf_pose, *args)
            self._kf_pose_dirty[:] = False
