"""Host driver for the sharded sliding-window stream (SURVEY.md §3.5, L4+L5).

Per-shard slot management lives on the host (it is pure bookkeeping over the
stream the host already owns): each shard has ``ecap`` buffer slots and a
free-slot stack; expiring edges free their slot, new edges claim one. The
device only ever sees fixed-shape, trash-slot-padded batches — every slide
step is one jitted sharded call, and for the wl engines the batch is ONE
packed int32 transfer per slide carrying only non-derivable data (fresh
edges + the slot schedule; see the slide builders in pprx.dist.wl).

All per-slide host work is vectorized NumPy (stable argsort grouping by
owner shard + flat-index packing into the padded [K, b] batch rows); the
only Python loops are O(K) over shards for the free-slot stacks. Measured
batch-build time is exposed as ``last_host_ms`` (the per-edge Python
loops this replaces were O(b) interpreter work/step).
"""

from __future__ import annotations

import time
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding

from pprx.config import PprConfig, StreamConfig
from pprx.dist.sharded import ShardedEngine
from pprx.engine.state import FORWARD


def _group(owner: np.ndarray, n_shards: int, row_len: int):
    """Group b items by owner shard WITHOUT sorting: since owners live in
    [0, K) with tiny K, an O(K) loop of boolean compactions gives each item
    a rank within its shard. Returns (flat, counts): ``flat`` indexes the
    shard-major padded [K*row_len] batch layout — shard k's items occupy
    [k*row_len, k*row_len + counts[k]), in stream order — so a pack is one
    allocation + one scatter. Alignment contract: every array packed with
    the SAME flat indices has entry (k, j) referring to the same edge."""
    rank = np.empty(owner.size, np.int64)
    counts = np.empty(n_shards, np.int64)
    for k in range(n_shards):
        idx = np.flatnonzero(owner == k)
        counts[k] = idx.size
        rank[idx] = np.arange(idx.size, dtype=np.int64)
    return owner.astype(np.int64) * row_len + rank, counts


def _pack(flat: np.ndarray, vals, n_rows: int, fillval: int = 0) -> np.ndarray:
    """Scatter values into the padded shard-major batch layout (contiguous
    fill + one scatter — measured ~10x faster than multi-column variants on
    this host's NumPy)."""
    out = np.empty(n_rows, np.int32)
    out.fill(fillval)
    out[flat] = vals
    return out


class ShardedStreamDriver:
    def __init__(
        self,
        stream_src: np.ndarray,
        stream_dst: np.ndarray,
        n: int,
        queries,
        cfg: PprConfig,
        scfg: StreamConfig,
        mesh: jax.sharding.Mesh,
        mode: int = FORWARD,
        ecap: int | None = None,
        dtype=jnp.float32,
        engine: str = "dense",
        ccap: int | None = None,
        fring: int | None = None,
        e_top: int | None = None,
    ):
        """engine: 'dense' (reduce-scatter rounds, pprx.dist.sharded),
        'wl' (compact-frontier rounds with bucketed a2a, pprx.dist.wl), or
        'wlp' (wl with the memory-proportional carry/drain rounds — no
        [n_pad, S] arrays; per-device memory scales with the shard)."""
        if stream_src.shape[0] < scfg.window:
            raise ValueError("stream shorter than one window")
        if engine not in ("dense", "wl", "wlp"):
            raise ValueError(f"unknown sharded engine {engine!r}")
        self.stream_src = np.asarray(stream_src, dtype=np.int32)
        self.stream_dst = np.asarray(stream_dst, dtype=np.int32)
        self.n = n
        self.cfg = cfg
        self.scfg = scfg
        self.mode = mode
        self._wl = engine in ("wl", "wlp")
        w = scfg.window
        queries = list(queries)
        if self._wl:
            from pprx.dist.wl import ShardedWlEngine

            self.eng = ShardedWlEngine(
                mesh, n, len(queries),
                ecap=w if ecap is None else ecap,
                bcap=scfg.slide, cfg=cfg, mode=mode, dtype=dtype,
                ccap=ccap, fring=fring, e_top=e_top,
                proportional=(engine == "wlp"),
            )
        else:
            self.eng = ShardedEngine(
                mesh,
                n,
                len(queries),
                ecap=w if ecap is None else ecap,
                bcap=scfg.slide,
                cfg=cfg,
                mode=mode,
                dtype=dtype,
                ccap=2048 if ccap is None else ccap,
            )
        eng = self.eng
        self.p, self.r = eng.init_state(queries)
        if self._wl:
            (self.deg, self.egl, self.eog, self.eva, counts,
             self.snap) = eng.device_graph_wl(
                self.stream_src[:w], self.stream_dst[:w]
            )
            self._fcnt_host = np.zeros(eng.n_rows, np.int64)
            self._since_rb = 0
        else:
            self.deg, self.egl, self.eog, self.eva, counts = eng.device_graph(
                self.stream_src[:w], self.stream_dst[:w]
            )
        # host slot bookkeeping: stream position -> (owner shard, local slot)
        self._gather_key = (
            self.stream_src if mode == FORWARD else self.stream_dst
        ) // eng.n_local
        self.pos_owner = np.full(self.stream_src.shape[0], -1, np.int32)
        self.pos_slot = np.full(self.stream_src.shape[0], -1, np.int32)
        gk0 = self._gather_key[:w]
        # one-time seed: slot of position = its rank within its owner group
        # (stream order); argsort grouping is fine here (not the hot path)
        fill = np.bincount(gk0, minlength=eng.n_rows).astype(np.int64)
        order = np.argsort(gk0, kind="stable")
        starts = np.zeros(eng.n_rows + 1, np.int64)
        np.cumsum(fill, out=starts[1:])
        rank = np.arange(w, dtype=np.int64) - np.repeat(starts[:-1], fill)
        self.pos_slot[order] = rank
        self.pos_owner[:w] = gk0
        assert (fill == counts).all()
        # per-shard LIFO free-slot stacks (top pointer; freed slots reused
        # before untouched tail slots)
        self._free_stack = [np.empty(eng.ecap, np.int32) for _ in range(eng.n_rows)]
        self._free_top = np.zeros(eng.n_rows, np.int64)
        for k in range(eng.n_rows):
            c = eng.ecap - int(fill[k])
            self._free_stack[k][:c] = np.arange(fill[k], eng.ecap, dtype=np.int32)
            self._free_top[k] = c
        self.head = w
        self.step_idx = 0
        self.last_host_ms = 0.0
        self._row_sh = NamedSharding(mesh, eng.row_spec)
        self.ring = self._device_ring() if (self._wl and mode == FORWARD) else None

    # -- helpers -------------------------------------------------------
    def _device_ring(self):
        """Build the forward wl slide's device slot-ring state (FIFO
        occupancy ring + free stack per shard; pprx.dist.wl.WL_RING_KEYS)
        from the host bookkeeping — the host simulation and the device
        replay use the same push-freed/pop-top schedule, so the two stay
        bit-identical. Also the checkpoint-resume path: a ring is fully
        determined by pos_owner/pos_slot/free stacks, so checkpoints carry
        no new fields (pprx/io/checkpoint.py)."""
        eng = self.eng
        K, ecap = eng.n_rows, eng.ecap
        live = np.arange(self.head - self.scfg.window, self.head)
        own, slots = self.pos_owner[live], self.pos_slot[live]
        oring = np.full((K, ecap + 2), ecap, np.int32)
        tl = np.zeros(K, np.int32)
        fstack = np.full((K, ecap + 1), ecap, np.int32)
        ftop = np.zeros(K, np.int32)
        for k in range(K):
            sl = slots[own == k]  # stream (= insertion) order
            oring[k, : sl.size] = sl
            tl[k] = sl.size  # < ecap + 1, no wrap possible
            t = int(self._free_top[k])
            fstack[k, :t] = self._free_stack[k][:t]
            ftop[k] = t
        return eng.make_ring(oring, np.zeros(K, np.int32), tl, fstack, ftop)

    def _rows_array(self, packed: np.ndarray) -> jnp.ndarray:
        return jax.device_put(jnp.asarray(packed), self._row_sh)

    def seed(self):
        if self._wl:
            (self.p, self.r, rounds, pushes, epushes, wl) = self.eng.push_wl(
                self.p, self.r, self.deg, self.snap
            )
            return {
                "rounds": int(rounds), "pushes": float(pushes),
                "edge_pushes": float(epushes), "wl_rounds": int(wl),
            }
        self.p, self.r, rounds, pushes, epushes = self.eng.push(
            self.p, self.r, self.deg, self.egl, self.eog, self.eva
        )
        return {"rounds": int(rounds), "pushes": float(pushes), "edge_pushes": float(epushes)}

    @property
    def steps_available(self) -> int:
        return (self.stream_src.shape[0] - self.head) // self.scfg.slide

    # -- the slide loop ------------------------------------------------
    def run(self, n_steps: int | None = None) -> Iterator[dict]:
        eng = self.eng
        b = self.scfg.slide
        n_local = eng.n_local
        total = self.steps_available if n_steps is None else n_steps
        for _ in range(total):
            if self.head + b > self.stream_src.shape[0]:
                return
            t_host = time.perf_counter()
            expire = np.arange(self.head - self.scfg.window, self.head - self.scfg.window + b)
            fresh = np.arange(self.head, self.head + b)
            K = eng.n_rows
            trash = eng.trash_slot
            src, dstv = self.stream_src, self.stream_dst
            ones = np.ones(b, np.int32)

            # by-src-owner correction batches; in forward mode the gather
            # key IS src, so the slot groupings coincide and everything
            # fuses into two multi-column scatters
            oo = src[expire] // n_local
            on = src[fresh] // n_local
            flat_o, cnt_o = _group(oo, K, b)
            flat_n, cnt_n = _group(on, K, b)
            go = self.pos_owner[expire]
            gn = self._gather_key[fresh]
            if self.mode == FORWARD:
                flat_c, cnt_c = flat_o, cnt_o
                flat_w, cnt_w = flat_n, cnt_n
            else:
                flat_c, cnt_c = _group(go, K, b)
                flat_w, cnt_w = _group(gn, K, b)
            clear_slots = _pack(flat_c, self.pos_slot[expire], K * b, fillval=trash)

            alloc_rows = np.full(K * b, trash, np.int32)
            for k in range(K):  # O(K) slot-stack pushes/pops
                c_fr, c_al = int(cnt_c[k]), int(cnt_w[k])
                t = int(self._free_top[k])
                if c_fr:
                    self._free_stack[k][t : t + c_fr] = clear_slots[k * b : k * b + c_fr]
                    t += c_fr
                if c_al:
                    if t < c_al:
                        raise RuntimeError(
                            f"shard {k} edge buffer full (ecap={eng.ecap}); "
                            "raise ecap to absorb this degree skew"
                        )
                    alloc_rows[k * b : k * b + c_al] = self._free_stack[k][t - c_al : t][::-1]
                    t -= c_al
                self._free_top[k] = t
            self.pos_owner[fresh] = gn
            self.pos_slot[fresh] = alloc_rows[flat_w]
            # forward: gather endpoint = src, so write_slots entry i aligns
            # with ins_* entry i (same owner key, same stream order)
            write_slots = alloc_rows
            wl_extra = {}
            if self._wl:
                # rebuild before the slide if the fresh ring would overflow
                # or the oldest fresh edge would outlive the window
                if (
                    (self._fcnt_host + cnt_w > eng.fring).any()
                    or (self._since_rb + 1) * b > self.scfg.window
                ):
                    self.snap = eng.rebuild(self.egl, self.eog, self.eva)
                    self._fcnt_host[:] = 0
                    self._since_rb = 0
                # ONE packed int32 transfer per slide: only non-derivable
                # data ships (fresh edges + the host's slot schedule).
                # Expiring edges / validity flags / the candidate seed are
                # derived on device (see the slide builders in pprx.dist.wl).
                Lp = eng.pack_len
                pk = np.zeros((K, Lp), np.int32)
                if self.mode == FORWARD:
                    # slot schedule derives on device (FIFO ring + free
                    # stack; see _device_ring) — only the fresh edges and
                    # the two per-shard counts ship
                    pk[:, 0:b] = _pack(
                        flat_n, (src[fresh] - on * n_local).astype(np.int32),
                        K * b,
                    ).reshape(K, b)
                    pk[:, b:2 * b] = _pack(
                        flat_n, dstv[fresh].astype(np.int32), K * b
                    ).reshape(K, b)
                    pk[:, 2 * b] = cnt_w
                    pk[:, 2 * b + 1] = cnt_c
                else:
                    pk[:, 0:b] = _pack(
                        flat_o, (src[expire] - oo * n_local).astype(np.int32),
                        K * b,
                    ).reshape(K, b)
                    pk[:, b:2 * b] = _pack(
                        flat_n, (src[fresh] - on * n_local).astype(np.int32),
                        K * b,
                    ).reshape(K, b)
                    pk[:, 2 * b:3 * b] = clear_slots.reshape(K, b)
                    pk[:, 3 * b:4 * b] = write_slots.reshape(K, b)
                    pk[:, 4 * b:5 * b] = _pack(
                        flat_w, (dstv[fresh] - gn * n_local).astype(np.int32),
                        K * b,
                    ).reshape(K, b)
                    pk[:, 5 * b:6 * b] = _pack(
                        flat_w, src[fresh].astype(np.int32), K * b
                    ).reshape(K, b)
                    pk[:, 6 * b] = cnt_o
                    pk[:, 6 * b + 1] = cnt_n
                    pk[:, 6 * b + 2] = cnt_w
            else:
                del_u = _pack(flat_o, (src[expire] - oo * n_local).astype(np.int32), K * b)
                del_w = _pack(flat_o, dstv[expire].astype(np.int32), K * b)
                del_v = _pack(flat_o, ones, K * b)
                ins_u = _pack(flat_n, (src[fresh] - on * n_local).astype(np.int32), K * b)
                ins_w = _pack(flat_n, dstv[fresh].astype(np.int32), K * b)
                ins_v = _pack(flat_n, ones, K * b)
                if self.mode != FORWARD:
                    write_dl = _pack(flat_w, (dstv[fresh] - gn * n_local).astype(np.int32), K * b)
                    write_sg = _pack(flat_w, src[fresh].astype(np.int32), K * b)
                    write_v = _pack(flat_w, ones, K * b)
            self.last_host_ms = (time.perf_counter() - t_host) * 1e3
            if getattr(self, "debug_batches", False):
                # timing scripts (scripts/sharded_phases.py) replay batches
                # standalone to decompose the fused slide program
                self._batches = {
                    "clear_slots": clear_slots, "write_slots": write_slots,
                    "del_u": _pack(flat_o, (src[expire] - oo * n_local).astype(np.int32), K * b),
                    "del_w": _pack(flat_o, dstv[expire].astype(np.int32), K * b),
                    "del_v": _pack(flat_o, ones, K * b),
                    "ins_u": _pack(flat_n, (src[fresh] - on * n_local).astype(np.int32), K * b),
                    "ins_w": _pack(flat_n, dstv[fresh].astype(np.int32), K * b),
                    "ins_v": _pack(flat_n, ones, K * b),
                }

            A = self._rows_array
            if self._wl:
                out = eng.slide_wl(
                    self.p, self.r, self.deg, self.egl, self.eog, self.eva,
                    self.snap, A(pk.reshape(-1)), self.ring,
                )
                if self.mode == FORWARD:
                    (self.p, self.r, rounds, pushes, epushes, wl,
                     self.deg, self.egl, self.eog, self.eva, self.snap,
                     self.ring) = out
                else:
                    (self.p, self.r, rounds, pushes, epushes, wl,
                     self.deg, self.egl, self.eog, self.eva, self.snap) = out
                wl_extra = {"wl_rounds": int(wl)}
                self._fcnt_host += cnt_w
                self._since_rb += 1
            elif self.mode == FORWARD:
                # forward: write batches are the by-src-owner insert batches,
                # which were filled in the same stream order per shard
                out = eng.slide(
                    self.p, self.r, self.deg, self.egl, self.eog, self.eva,
                    A(del_u), A(del_w), A(del_v),
                    A(ins_u), A(ins_w), A(ins_v),
                    A(clear_slots), A(write_slots),
                )
            else:
                out = eng.slide(
                    self.p, self.r, self.deg, self.egl, self.eog, self.eva,
                    A(del_u), A(del_v), A(ins_u), A(ins_v),
                    A(clear_slots), A(write_slots),
                    A(write_dl), A(write_sg), A(write_v),
                )
            if not self._wl:
                (self.p, self.r, rounds, pushes, epushes,
                 self.deg, self.egl, self.eog, self.eva) = out
            self.head += b
            self.step_idx += 1
            yield {
                "rounds": int(rounds),
                "pushes": float(pushes),
                "edge_pushes": float(epushes),
                **wl_extra,
            }

    # -- host views ----------------------------------------------------
    def host_p(self) -> np.ndarray:
        return np.asarray(jax.device_get(self.p))

    def host_r(self) -> np.ndarray:
        return np.asarray(jax.device_get(self.r))

    def host_deg(self) -> np.ndarray:
        return np.asarray(jax.device_get(self.deg))
