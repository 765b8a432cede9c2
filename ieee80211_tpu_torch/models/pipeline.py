"""Fixed-config end-to-end receive step: trigger-relative windows in,
descrambled DATA bits out.

Port of the flagship receiver ieee80211_tpu/models/pipeline.py
(`make_rx_step` :28, `RxPipeline` :121). Sync, CFO, channel estimation,
L-SIG validation, per-symbol demod and the 64-state Viterbi run batched on
the device of the input; the two window slices and the two Viterbi decodes
of a step launch the hand-written CUDA kernels when that device is a GPU.

On a GPU, `RxStep.forward` replays the step as one CUDA graph per input
key (device, the shapes and dtypes of both inputs, inference mode): the
first call of a key runs the stages op by op, the second captures them,
and every later call copies its inputs into the graph's, replays it and
returns clones of its outputs. A replay calls no kernel wrapper, so the
`LAUNCHES` counters of ops/cuda/ do not count the kernels it launches;
GRAPH_CAPTURES, GRAPH_REPLAYS and EAGER_STEPS below count the paths.

The receive path has no trained weights: its state is the constant tables
that `tables_from_numpy` builds, held as registered buffers.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..ops import coding, demod, sync
from ..specs import BW, CR, F, Mod, tables
from ..specs import interleaver as ilv
from ..utils.device import entry_device
from ..utils.metrics import call_span, span
from ..utils.riq import r2c

OFF_LSIG = 128
OFF_NLLTF = 448

GRAPH_CAP = 4          # captured graphs kept per RxStep (least recently used
                       # dropped); each holds a private memory pool
GRAPH_CAPTURES = 0     # CUDA graphs captured by RxStep.forward so far
GRAPH_REPLAYS = 0      # their replays (one per graphed call)
EAGER_STEPS = 0        # CUDA calls run op by op: the first call of a key
# one capture at a time in the process (CUDA graphs allow no more), and a
# graph's static inputs and outputs belong to one call at a time
_GRAPH_LOCK = threading.Lock()


def _pilot_index(mod: Mod) -> int:
    """Pilot-polarity index of the first DATA symbol."""
    return {F.L: 1, F.HT: 3}.get(mod.fmt, 4)


def data_tables_from_numpy(mod: Mod, n_sym: int) -> Dict[str, np.ndarray]:
    """The constant tables of a DATA decode for (mod, n_sym), as numpy:
    DFT, LTF references, pilots, tone maps, deinterleaver, Viterbi radix
    tables and scrambler tables (shared with the streaming receiver's
    decoders, rx/receiver.py)."""
    q = tables.NFFT[mod.bw] // 64
    legacy = mod.fmt == F.L
    w0, w1 = coding._radix_tables(coding.RADIX)
    dft_re, dft_im = demod._dft_mats(64 * q)
    out = {
        "dft_re": dft_re,
        "dft_im": dft_im,
        "ltf_ref_l": demod.ltf_ref_grid(mod.bw, True),
        "vit_w0": w0,
        "vit_w1": w1,
        "pilot_ref": demod.pilot_refs(mod, n_sym, _pilot_index(mod)),
        "pilot_idx": tables.PILOT_GRID[(mod.bw, legacy)],
        "data_idx": tables.DATA_GRID[(mod.bw, legacy)],
        "rx_perm": ilv.rx_perm(mod, 0),
        "prbs": coding._prbs_tiled(n_sym * mod.nDBPS),
        "seed_inv": coding._seed_from_first7(),
    }
    if not legacy:
        out["ltf_ref_nl"] = demod.ltf_ref_grid(mod.bw, False)
    return as_tables(out)


def as_tables(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Cast numpy tables to the dtypes the JAX package holds them in:
    complex64, float32, int64 for index tables (`*_idx`, `*_perm`), any
    other integer table as it is."""
    for name, arr in out.items():
        arr = np.asarray(arr)
        if np.iscomplexobj(arr):
            arr = arr.astype(np.complex64)
        elif np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        elif name.endswith(("_idx", "_perm")):
            arr = arr.astype(np.int64)
        out[name] = np.ascontiguousarray(arr)
    return out


def tables_from_numpy(mod: Mod, n_sym: int) -> Dict[str, np.ndarray]:
    """Every constant table of the receive step for (mod, n_sym), as numpy.

    Built by the same numpy helpers as the JAX package (copied into the
    port's ops modules). Index tables are int64; complex references are
    complex64, as JAX holds them.
    """
    q = tables.NFFT[mod.bw] // 64
    # legacy-band duplicated SIG indexing (wide bw): the copies are combined
    d20 = np.asarray(tables.DATA_GRID[(BW.BW20, True)])
    p20 = np.asarray(tables.PILOT_GRID[(BW.BW20, True)])
    out = data_tables_from_numpy(mod, n_sym)
    out.update(as_tables({
        "band": sync.ltf_band_mat(q),
        "sig_data_idx": np.concatenate([d20 + 64 * c for c in range(q)]),
        "sig_pilot_idx": np.concatenate([p20 + 64 * c for c in range(q)]),
        "sig_pilot_ref": (np.tile(tables.PILOT_L, q)[None]
                          * tables.PILOT_POLARITY[0:1, None]),
        "sig_perm": ilv.sig_rx_perm(),
    }))
    return out


def graph_key(x2: torch.Tensor, t0: torch.Tensor) -> tuple:
    """What selects a step's CUDA graph: the device, the shapes and dtypes
    of both inputs, and whether inference mode is on."""
    return (x2.device, tuple(x2.shape), x2.dtype, t0.device,
            tuple(t0.shape), t0.dtype, torch.is_inference_mode_enabled())


class _Graphed:
    """One captured step: its static inputs, the graph, its static outputs,
    and an event behind the last call's clones."""
    __slots__ = ("x2", "t0", "graph", "out", "done")


class RxStep(nn.Module):
    """The receive step for a static (Mod, n_sym) config (any bw).

    forward(x2: [B, W, 2] float32 I/Q, t0: [B] int32) -> dict with
    bits [B, n_bits] int32 descrambled data bits, ltf_start [B] int32,
    cfo [B] float32, snr [B] float32, lsig_ok [B] bool: the keys and dtypes
    of the JAX step, fresh tensors on every call. csi_weight: per-tone
    |H|^2 LLR weighting (`demod.demod_data_siso`); False gives the
    reference's unweighted demap.
    """

    def __init__(self, mod: Mod, n_sym: int, csi_weight: bool = True):
        super().__init__()
        self.mod = mod
        self.n_sym = n_sym
        self.csi_weight = csi_weight
        self.q = tables.NFFT[mod.bw] // 64
        for name, arr in tables_from_numpy(mod, n_sym).items():
            self.register_buffer(name, torch.from_numpy(arr))
        # graph key -> _Graphed, and the keys seen once (eager), both
        # least recently used first and GRAPH_CAP long at most
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self._seen: "collections.OrderedDict" = collections.OrderedDict()

    def _apply(self, fn, *args, **kwargs):
        # a graph reads the tables where they lay when it was captured
        self._graphs.clear()
        self._seen.clear()
        return super()._apply(fn, *args, **kwargs)

    def data_offset(self) -> int:
        mod = self.mod
        if mod.fmt == F.L:
            off = OFF_LSIG + 80
        elif mod.fmt == F.HT:
            off = OFF_NLLTF + 80 * mod.nLTF
        else:
            off = OFF_NLLTF + 80 * mod.nLTF + 80
        return off * self.q

    def z_len(self) -> int:
        """Length of the packet-aligned window z: LTF through DATA."""
        return 32 * self.q + self.data_offset() + 80 * self.q * self.n_sym

    def _fft(self, x: torch.Tensor) -> torch.Tensor:
        return demod.fft_syms(x, self.dft_re, self.dft_im)

    # -- the step's stages, in order: _eager composes them, and
    # perf/stages.py times each one alone on the step's own tensors --------
    def sync_front(self, x2: torch.Tensor, t0: torch.Tensor):
        """1. STF coarse CFO, LTF plateau timing, fine CFO: (ltf_start,
        cfo, snr)."""
        return sync.sync_front_iq(x2, t0, self.band, q=self.q)

    def window(self, x2: torch.Tensor, ltf_start: torch.Tensor):
        """2. ONE aligned window slice per packet, [B, z_len, 2]: LTF
        through DATA, from ltf_start - 16q. Everything downstream is static
        slicing of it."""
        return sync.batch_slice_iq(x2, ltf_start - 16 * self.q, self.z_len())

    def derotate(self, z2: torch.Tensor, cfo: torch.Tensor):
        """3. The CFO ramp: z [B, z_len] complex64. Its constant phase
        offset against absolute time cancels in equalization."""
        return r2c(z2) * sync.cfo_ramp(cfo, z2.shape[1])

    def symbol_windows(self, z: torch.Tensor):
        """The OFDM symbol windows of z: L-LTF [B, 2, N], L-SIG [B, 1, N],
        HT/VHT-LTF [B, 1, N] (None for legacy) and DATA [B, n_sym, N]."""
        q = self.q
        # data-symbol window shift 4q, not the reference's 8q: it re-centres
        # the cyclic-prefix margin for multipath (CLAUDE.md, "RX
        # correctness (round 5)"); clean-channel decodes are unchanged
        nfft, gi, sh = 64 * q, 16 * q, 4 * q

        def syms(off, n, stride=None):
            return demod.static_symbol_windows(z, off, n, nfft=nfft, gi=gi,
                                               shift=sh, stride=stride)

        nl = (None if self.mod.fmt == F.L
              else syms(gi + OFF_NLLTF * q, 1))
        return (syms(0, 2, nfft), syms(gi + OFF_LSIG * q, 1), nl,
                syms(gi + self.data_offset(), self.n_sym))

    def grids(self, z: torch.Tensor):
        """4. The symbol windows and their DFTs (`demod.fft_syms`): the
        frequency grids of `symbol_windows`, in its order."""
        return tuple(None if w is None else self._fft(w)
                     for w in self.symbol_windows(z))

    def lsig(self, ltf_g: torch.Tensor, sig_g: torch.Tensor):
        """5. The L-LTF channel estimate, then L-SIG (always decoded, as in
        the reference receiver): equalize, pilot phase, the 24-bit Viterbi,
        parity. Returns (legacy channel [B, N], lsig_ok [B])."""
        lchan = demod.legacy_chan_est(ltf_g, self.ltf_ref_l)
        eq = demod.equalize(sig_g, lchan)
        ph = demod.pilot_phase(eq, self.sig_pilot_ref, self.sig_pilot_idx)
        eq = (eq / ph[..., None])[:, 0]
        tones = eq[:, self.sig_data_idx]
        tones = tones.reshape(tones.shape[0], self.q, 48).sum(dim=1)
        lsig_llr = tones.real[:, self.sig_perm]
        lsig_bits = coding.viterbi_decode(lsig_llr, CR.CR12, 24,
                                          self.vit_w0, self.vit_w1)
        return lchan, (lsig_bits[:, :17].sum(dim=-1) % 2) == lsig_bits[:, 17]

    def chan_est(self, lchan: torch.Tensor, nl_g):
        """6. The DATA field's channel: the HT/VHT-LTF estimate, or the
        legacy one for a legacy packet."""
        if nl_g is None:
            return lchan
        return demod.nonlegacy_chan_est_siso(nl_g[:, 0], self.ltf_ref_nl)

    def data_llrs(self, data_g: torch.Tensor, chan: torch.Tensor):
        """7. ZF, pilot phase, the (CSI-weighted) LLR demap and the
        deinterleave: LLRs [B, n_coded]."""
        return demod.demod_data_siso(data_g, chan, self.mod, self.pilot_ref,
                                     self.pilot_idx, self.data_idx,
                                     self.rx_perm,
                                     csi_weight=self.csi_weight)

    def viterbi(self, llrs: torch.Tensor):
        """8. The DATA Viterbi: bits [B, n_sym * nDBPS] int32."""
        return coding.viterbi_decode(llrs, self.mod.cr,
                                     self.n_sym * self.mod.nDBPS,
                                     self.vit_w0, self.vit_w1)

    def descramble(self, bits: torch.Tensor):
        """9. The scrambler seed from the service bits, the PRBS removed."""
        return coding.descramble(bits, self.prbs, self.seed_inv)

    def forward(self, x2: torch.Tensor, t0: torch.Tensor):
        """The step under the call's span `step` (utils/metrics.py): op by
        op (`_eager`) on the CPU and on a key's first CUDA call, else a
        replay of the key's CUDA graph (`step.replay`), captured on the
        second call (`step.capture`)."""
        with call_span("step"):
            if x2.device.type != "cuda":
                return self._eager(x2, t0)
            return self._graphed(x2, t0)

    def _eager(self, x2: torch.Tensor, t0: torch.Tensor):
        """The nine stages in order, each a span `step.<stage>`."""
        with span("step.sync_front"):
            ltf_start, cfo, snr = self.sync_front(x2, t0)
        with span("step.window"):
            z2 = self.window(x2, ltf_start)
        with span("step.derotate"):
            z = self.derotate(z2, cfo)
        with span("step.grids"):
            ltf_g, sig_g, nl_g, data_g = self.grids(z)
        with span("step.lsig"):
            lchan, lsig_ok = self.lsig(ltf_g, sig_g)
        with span("step.chan_est"):
            chan = self.chan_est(lchan, nl_g)
        with span("step.data_llrs"):
            llrs = self.data_llrs(data_g, chan)
        with span("step.viterbi"):
            bits = self.viterbi(llrs)
        with span("step.descramble"):
            bits = self.descramble(bits)
        return dict(bits=bits, ltf_start=ltf_start, cfo=cfo, snr=snr,
                    lsig_ok=lsig_ok)

    def _graphed(self, x2: torch.Tensor, t0: torch.Tensor):
        """A CUDA call: op by op at a key's first sight, else its graph."""
        global EAGER_STEPS
        key = graph_key(x2, t0)
        with _GRAPH_LOCK:
            if key in self._graphs or key in self._seen:
                with torch.cuda.device(x2.device):
                    return self._replay(key, x2, t0)
            _remember(self._seen, key, True)
            EAGER_STEPS += 1
        return self._eager(x2, t0)

    def _replay(self, key: tuple, x2: torch.Tensor, t0: torch.Tensor):
        """Replay the key's graph on the current stream, capturing it first
        if it has none; the outputs cloned out of the graph's."""
        global GRAPH_REPLAYS
        g = self._graphs.get(key)
        if g is None:
            with span("step.capture"):
                g = self._capture(x2, t0)
            self._seen.pop(key, None)
            _remember(self._graphs, key, g)
        else:
            self._graphs.move_to_end(key)
        with span("step.replay"):
            cur = torch.cuda.current_stream()
            cur.wait_event(g.done)     # the last call's clones, on any stream
            g.x2.copy_(x2)
            g.t0.copy_(t0)
            g.graph.replay()
            out = {k: v.clone() for k, v in g.out.items()}
            g.done.record(cur)
        GRAPH_REPLAYS += 1
        return out

    def _capture(self, x2: torch.Tensor, t0: torch.Tensor) -> _Graphed:
        """Capture `_eager` on copies of the inputs, after one warm-up on
        the capture's own stream (PyTorch's CUDA graph recipe), without
        blocking other threads' CUDA calls. PyTorch ties its default CUDA
        generator to every capture: another thread that draws from it
        while the capture is underway raises (the port draws only from
        generators of its own)."""
        global GRAPH_CAPTURES
        g = _Graphed()
        g.x2, g.t0 = x2.clone(), t0.clone()
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._eager(g.x2, g.t0)
        cur.wait_stream(side)
        g.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g.graph, stream=side,
                              capture_error_mode="thread_local"):
            g.out = self._eager(g.x2, g.t0)
        g.done = torch.cuda.Event()
        GRAPH_CAPTURES += 1
        return g


def _remember(lru: "collections.OrderedDict", key, value) -> None:
    """Put key last in lru, dropping the least recently used beyond
    GRAPH_CAP."""
    lru[key] = value
    lru.move_to_end(key)
    while len(lru) > GRAPH_CAP:
        lru.popitem(last=False)


class RxPipeline(nn.Module):
    """Fixed-config receiver: `step(x2, t0)` runs the receive step on the
    module's device: the card unless `device="cpu"` asks for the CPU
    (without a card, the default raises). csi_weight as in `RxStep`."""

    def __init__(self, mod: Mod, n_sym: int, psdu_len: int, *,
                 csi_weight: bool = True, device=None):
        super().__init__()
        self.mod = mod
        self.n_sym = n_sym
        self.psdu_len = psdu_len
        self.step = RxStep(mod, n_sym, csi_weight).to(entry_device(device))

    def window_len(self) -> int:
        base = 192 + 128 + 80  # sync slack + LTF + L-SIG
        if self.mod.fmt == F.L:
            extra = 0
        elif self.mod.fmt == F.HT:
            extra = 160 + 80 + 80 * self.mod.nLTF
        else:
            extra = 160 + 80 + 80 * self.mod.nLTF + 80
        q = tables.NFFT[self.mod.bw] // 64
        return (base + extra + 80 * self.n_sym + 80) * q

    def forward(self, x2: torch.Tensor, t0: torch.Tensor):
        return self.step(x2, t0)
