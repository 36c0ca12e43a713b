"""Host (numpy) oracle of the encoder (the port's copy of
iivision_tpu/encoder_host.py).

A host tool, like `plan` and `emit`: it runs on the CPU whatever device
the distance model lives on, and launches no kernel.  It implements the
encoder's algorithm scalar and readable, for differential testing: with
zero nonces (seed=None) it and `encoder.encode_movies` emit identical
opcode streams and final screens, on the CPU's plain forms or the card's
kernels.  The distance model's tables are read to the host (`.cpu()`), and
the chunk-start diff calls `distance.dist_lane_pairs` on CPU tensors, its
plain version.

A seed draws the nonces from numpy's RandomState, as the JAX package's
oracle does, not from the encoder's threefry streams.
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from iivision_tpu_torch import screen
from iivision_tpu_torch.ops import distance
from iivision_tpu_torch.video_mode import VideoMode, require_mode


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class HostEncoder:
    """Scalar mirror of the encoder's chunk starts and steps."""

    def __init__(self, mode: VideoMode, dist, k: int = 8,
                 seed: Optional[int] = None, j: int = 1,
                 joint: bool = False):
        self.mode = require_mode(mode)
        self.joint = joint
        self.spec = screen.spec_for_mode(mode)
        self.store_cost = _host(dist.store_cost16).astype(np.int16)
        self.sub = torch.as_tensor(_host(dist.sub).astype(np.int32))
        self.k = k
        self.j = j
        self.n_banks = 2 if mode == VideoMode.DHGR else 1
        self.C = distance.n_contents(mode)
        self.banks = np.zeros((self.n_banks, 32, 256), np.int32)
        self.up = np.zeros((self.n_banks, 32, 256), np.int32)
        self.dw = np.zeros((self.n_banks, 32, 256), np.int32)
        # the active bank's store-cost slab sc[page, offset, content],
        # rebuilt at every chunk-start recompute
        self.sc = np.zeros((32, 256, self.C), np.int32)
        self.not_hole = (~screen.SCREEN_HOLES).astype(np.int32)
        self.rng = np.random.RandomState(seed) if seed is not None else None

    def _cur_lanes(self) -> torch.Tensor:
        if self.mode == VideoMode.DHGR:
            return screen.dhgr_masked_lanes(torch.from_numpy(self.banks[0]),
                                            torch.from_numpy(self.banks[1]))
        return screen.hgr_masked_lanes(torch.from_numpy(self.banks[0]))

    def _bank_lanes(self, bank) -> Tuple[int, int]:
        if self.mode == VideoMode.DHGR:
            return self.spec.bank_lanes(bank == 1)
        return self.spec.bank_lanes(False)

    def _nonce(self, shape):
        if self.rng is None:
            return np.zeros(shape, np.float32)
        return self.rng.uniform(size=shape).astype(np.float32)

    def recompute(self, tgt_lanes, bank: int):
        """Chunk-start refresh: the DP diff of the active bank and its
        store-cost slab sc[page, offset, content]."""
        cur = self._cur_lanes()
        tgt_lanes = _host(tgt_lanes)
        tgt = torch.as_tensor(tgt_lanes.astype(np.int32))
        le, lo = self._bank_lanes(bank)
        de, do = (distance.dist_lane_pairs(cur[:, :, l], tgt[:, :, l],
                                           self.mode, l, self.sub)
                  for l in (le, lo))
        d = screen.interleave_bank_lanes(de, do).numpy()
        d = d.astype(np.int32) * self.not_hole
        up = self.up[bank]
        self.up[bank] = np.where(d == 0, 0, up) + d
        self.dw[bank] = d
        se = self.store_cost[le][tgt_lanes[:, :, le]]  # (32, 128, C)
        so = self.store_cost[lo][tgt_lanes[:, :, lo]]
        self.sc = np.stack([se, so], axis=2).reshape(
            32, 256, self.C).astype(np.int32)

    def step(self, tgt_bytes, frame: int, bank: int,
             nvalid: int) -> List[Tuple]:
        up = self.up[bank]
        dw = self.dw[bank]
        bank_bytes = self.banks[bank]

        page_max = up.max(axis=1)
        score = page_max.astype(np.float32) * 256.0 + self._nonce(32) * 255.0
        pages = np.argsort(-score, kind="stable")[:self.k]
        nonce_o = self._nonce((self.j, self.k, 256))

        ops = []
        for idx in range(nvalid):
            # sub-op-major order: all selected pages' first ops, then their
            # second ops, ...; each sub-op sees earlier sub-ops' updates on
            # the same page
            jj, slot = divmod(idx, self.k)
            pg = int(pages[slot])
            if up[pg].max() <= 0:
                ops.append((32, int(tgt_bytes[0, 0]), 0, 0, 0, 0))
                continue
            off_score = up[pg].astype(np.float32) * 256.0 \
                + nonce_o[jj, slot] * 255.0
            off0 = int(np.argmax(off_score))
            if self.joint:
                # joint content: argmax over all C content codes of [gain
                # at the fixed primary offset + 3 best positive companion
                # gains].  All terms are integers < 2^18, exact in float32
                block = self.sc[pg].astype(np.float32)  # (256, C)
                score_all = dw[pg].astype(np.float32)[:, None] - block
                prim = score_all[off0].copy()  # (C,)
                eligj = (up[pg] > 0) & (np.arange(256) != off0)
                slj = np.where(eligj[:, None] & (score_all > 0.0),
                               score_all, 0.0).astype(np.float32)
                comp = np.zeros(self.C, np.float32)
                for _ in range(3):
                    o = np.argmax(slj, axis=0)  # (C,)
                    vals = slj[o, np.arange(self.C)]
                    comp += vals
                    slj[o, np.arange(self.C)] = 0.0
                content = int(np.argmax(prim + comp))
            else:
                content = int(tgt_bytes[pg, off0])

            # companions: rank all offsets of the page against the LIVE
            # diff; the cost index masks the DHGR palette bit, the emitted
            # byte stays raw
            sc_row = self.sc[pg, :, content & (self.C - 1)]  # (256,)
            cscore = dw[pg] - sc_row
            elig = (up[pg] > 0) & (cscore > 0) \
                & (np.arange(256) != off0)
            s = np.where(elig, cscore.astype(np.float32), -1.0)
            offs = [off0]
            for _ in range(3):  # best three, ties to lowest offset
                o = int(np.argmax(s))
                if s[o] <= 0.0:
                    break
                offs.append(o)
                up[pg, o] = int(sc_row[o])
                bank_bytes[pg, o] = content
                s[o] = -1.0
            while len(offs) < 4:
                offs.append(off0)
            bank_bytes[pg, off0] = content
            if self.joint:
                # the primary keeps its residual error: joint may have
                # stored a non-target byte
                r = int(sc_row[off0])
                up[pg, off0] = r
                dw[pg, off0] = r
            else:
                up[pg, off0] = 0
                dw[pg, off0] = 0
            ops.append((pg + 32, content, offs[0], offs[1], offs[2], offs[3]))
        return ops


def encode_movie_host(dist, lanes_tgt, bytes_tgt, plan, mode: VideoMode,
                      seed: Optional[int] = None,
                      joint: bool = False) -> np.ndarray:
    """Run the full planned movie on the host; returns (n_ops, 6) int32.
    lanes_tgt (F, 32, 128, L) and bytes_tgt (F, 2, 32, 256): tensors on
    any device, or arrays."""
    enc = HostEncoder(mode, dist, k=plan.k, seed=seed, j=plan.j,
                      joint=joint)
    return np.asarray(run_plan(enc, lanes_tgt, bytes_tgt, plan),
                      dtype=np.int32)


def run_plan(enc: HostEncoder, lanes_tgt, bytes_tgt, plan) -> list:
    """Every step of `plan` on `enc` (its screens and diffs carry the
    result), the chunk starts included; returns the ops."""
    lanes_tgt = _host(lanes_tgt)
    bytes_tgt = _host(bytes_tgt)
    out = []
    for s in range(len(plan.step_frame)):
        f = int(plan.step_frame[s])
        bank = int(plan.step_bank[s])
        if plan.step_recompute[s]:
            enc.recompute(lanes_tgt[f], bank)
        out.extend(enc.step(bytes_tgt[f, bank], f, bank,
                            int(plan.step_nvalid[s])))
    return out
