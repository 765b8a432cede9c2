"""The port's dual-chain receiver (ieee80211_tpu_torch.rx.MimoReceiver) end
to end on the CPU, against the JAX package's MimoReceiver, on the universal
capture of tests/test_dual_chain_universal.py: legacy, SISO HT and VHT
(MRC), a 2x2 VHT packet and a VHT NDP on two chains, with both chains live
and with chain 0 faded to nothing.

Format, MCS, PSDU, MPDUs, FCS and SIG-B flags, the number of per-stream
EVM SNRs and the number of NDPs must be equal; CFO, SNR and EVM SNRs within
`torch_parity`'s tolerances, an NDP's CFO-corrected LTF samples within 1e-5
and its CFO within 1e-6 rad/sample. The numpy copies (planner,
`merge_triggers`, the int8 upload) must equal their originals exactly, and
the decoders' buffers must be the tables the JAX package's helpers build.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ieee80211_tpu.ops import demod as jdemod
from ieee80211_tpu.rx import mimo as jmimo
from ieee80211_tpu.specs import BW, F, Mod
from ieee80211_tpu.specs import interleaver as ilv
from ieee80211_tpu_torch.ops.cuda import gather as kg
from ieee80211_tpu_torch.ops.cuda import viterbi as kv
from ieee80211_tpu_torch.rx import (MimoDataDecoder, MimoReceiver,
                                    MrcDataDecoder, SisoReceiver,
                                    get_mimo_decoder, get_mrc_decoder)
from ieee80211_tpu_torch.rx import mimo
from test_dual_chain_universal import _mixed_capture
from test_torch_receiver_plan import _assert_plans_equal, _random_meta
from torch_parity import assert_same_packets_all, port_mod, snr_tol_db

RATES = [20e6, 40e6, 80e6]


def _dual(dead: bool):
    return _mixed_capture(dead_chain0=dead, noise=1e-4 if dead else 2e-4)


@pytest.fixture(scope="module", params=[False, True],
                ids=["live", "dead_chain0"])
def universal(request):
    cap, want = _dual(request.param)
    jrx = jmimo.MimoReceiver()
    return cap, want, jrx.decode_capture_full(cap), jrx.stats.summary()


def _assert_same_ndps(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r) == 2          # one capture per RX chain
        for gc, rc in zip(g, r):
            assert set(dataclasses.asdict(gc)) == set(dataclasses.asdict(rc))
            assert gc.ltf_iq.shape == rc.ltf_iq.shape == (128,)
            np.testing.assert_allclose(gc.ltf_iq, rc.ltf_iq, rtol=0,
                                       atol=1e-5)
            assert abs(gc.cfo_rad - rc.cfo_rad) <= 1e-6
            assert abs(gc.snr_db - rc.snr_db) <= snr_tol_db(rc.snr_db)


def test_decode_capture_full_equals_jax(universal):
    cap, want, (jpkts, jndps), jstats = universal
    rx = MimoReceiver(device="cpu")
    pkts, ndps = rx.decode_capture_full(cap)
    got = {(r.fmt, r.mcs): r for r in pkts if r.fcs_ok}
    assert set(got) == set(want)
    for key, mpdu in want.items():
        assert got[key].mpdus[0] == mpdu
    assert got[(F.VHT, 4)].sigb_ok is True and len(got[(F.VHT, 4)].sssnr) == 2
    assert got[(F.VHT, 7)].sigb_ok is True and len(got[(F.VHT, 7)].sssnr) == 1
    assert got[(F.HT, 5)].sigb_ok is None
    assert_same_packets_all(pkts, jpkts)
    assert len(ndps) == 1
    _assert_same_ndps(ndps, jndps)
    assert rx.stats.summary() == jstats


@pytest.mark.parametrize("ingest", ["f32", "int8"])
def test_decode_captures_equal_decode_capture(ingest):
    """The inherited pipelined stream, with and without NDPs surfaced, gives
    decode_capture's packets on every capture (five, so that every stage of
    the pipeline runs), and decode_capture equals JAX's at this ingest."""
    cap, want = _dual(False)
    caps = [np.concatenate([np.zeros((2, 64 + 32 * k), np.complex64), cap],
                           axis=1) for k in range(5)]
    rx = MimoReceiver(ingest=ingest, device="cpu")
    single = [rx.decode_capture(c) for c in caps[:2]]
    assert_same_packets_all(single[0], jmimo.MimoReceiver(
        ingest=ingest).decode_capture(caps[0]))
    stream = MimoReceiver(ingest=ingest, device="cpu").decode_captures(caps)
    full, ndps = MimoReceiver(ingest=ingest,
                              device="cpu").decode_captures_full(caps)
    assert len(stream) == len(full) == len(ndps) == 5
    for k in range(5):
        assert_same_packets_all(stream[k], single[k % 2])
        assert_same_packets_all(full[k], single[k % 2])
        assert sum(r.fcs_ok for r in stream[k]) == len(want)
        assert len(ndps[k]) == 1 and len(ndps[k][0]) == 2


def test_ingest_int8_scales_per_chain_as_jax():
    """The native per-chain scan + quantize: the same triggers as JAX, and
    the port's dequantized upload equals JAX's int8 upload times its
    [2, 1, 1] scales, exactly."""
    cap, _ = _dual(False)
    cap[1] *= 3.0                         # unequal chains, unequal scales
    t0s, cap_dev, npad = MimoReceiver(ingest="int8", device="cpu")._ingest(cap)
    jt0s, jcap, jscale, jnpad = jmimo.MimoReceiver(ingest="int8")._ingest(
        cap)
    jscale = np.asarray(jscale)
    assert jscale.shape == (2, 1, 1) and jscale[1, 0, 0] != jscale[0, 0, 0]
    np.testing.assert_array_equal(t0s, jt0s)
    assert npad == jnpad and tuple(cap_dev.shape) == (2, npad, 2)
    np.testing.assert_array_equal(
        cap_dev.numpy(), np.asarray(jcap).astype(np.float32) * jscale)


@pytest.mark.parametrize("ingest", ["f32", "int8"])
def test_upload_equals_jax(ingest):
    """The upload without the native runtime: int8 quantizes both chains
    with ONE peak over both, as JAX's fallback does."""
    cap, _ = _dual(False)
    cap[1] *= 3.0
    got, npad = MimoReceiver(ingest=ingest, device="cpu")._upload(cap)
    jcap, jscale, jnpad = jmimo.MimoReceiver(ingest=ingest)._upload(cap)
    assert npad == jnpad
    jcap = np.asarray(jcap)
    assert jcap.dtype == (np.int8 if ingest == "int8" else np.float32)
    np.testing.assert_array_equal(
        got.numpy(), jcap.astype(np.float32) * np.float32(jscale))


def test_auto_ingest_switches_at_half_the_siso_length():
    rx, siso = MimoReceiver(device="cpu"), SisoReceiver(device="cpu")
    assert rx._mode(1 << 19) == "f32" and rx._mode(1 << 20) == "int8"
    assert siso._mode(1 << 20) == "f32" and siso._mode(1 << 21) == "int8"
    assert MimoReceiver(ingest="f32", device="cpu")._mode(1 << 22) == "f32"


def test_merge_triggers_equals_jax():
    rng = np.random.default_rng(6)
    for gap in (200, 800):
        chains = [np.sort(rng.integers(0, 50000, 60)) for _ in range(2)]
        got = mimo.merge_triggers(chains, dedup_gap=gap)
        want = jmimo.merge_triggers(chains, dedup_gap=gap)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert len(mimo.merge_triggers([np.array([5]), np.array([], np.int64)],
                                   10)) == 1


@pytest.mark.parametrize("fs", RATES, ids=["20MHz", "40MHz", "80MHz"])
def test_plan_batch_and_plan_one_equal_jax_on_random_meta(fs):
    port = MimoReceiver(sample_rate_hz=fs, device="cpu")
    ref = jmimo.MimoReceiver(sample_rate_hz=fs)
    rng = np.random.default_rng(int(fs // 1e6) + 1)
    n, cap_len = 3000, 150000
    meta = _random_meta(rng, n, port.bw)
    got, got_ndp = port._plan_batch(cap_len, meta, n)
    want, want_ndp = ref._plan_batch(cap_len, meta, n)
    assert len(want) > 10 and len(want_ndp) > 5
    _assert_plans_equal(got, want)
    _assert_plans_equal(got_ndp, want_ndp)
    assert {p.mod.nSS for _, p in want} == {1, 2}
    for i in range(0, n, 7):
        g, w = port._plan_one(cap_len, meta, i), ref._plan_one(cap_len,
                                                               meta, i)
        assert (g is None) == (w is None)
        if w is not None:
            assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_plan_batch_equals_plan_one_on_the_universal_capture():
    cap, _ = _dual(False)
    rx = MimoReceiver(device="cpu")
    t0s, cap_dev, npad = rx._ingest(cap)
    meta = rx._parse_sigs(cap_dev, npad, t0s)
    plans, ndps = rx._plan_batch(cap.shape[1], meta, len(t0s))
    one = [(i, rx._plan_one(cap.shape[1], meta, i)) for i in range(len(t0s))]
    one = [(i, p) for i, p in one if p is not None]
    _assert_plans_equal(plans, [(i, p) for i, p in one if not p.ndp])
    _assert_plans_equal(ndps, [p for _, p in one if p.ndp])
    want, want_ndps = jmimo.MimoReceiver()._plan_batch(cap.shape[1], meta,
                                                        len(t0s))
    _assert_plans_equal(plans, want)
    _assert_plans_equal(ndps, want_ndps)
    assert len(plans) == 4 and len(ndps) == 1


MIMO_MODS = [(Mod(F.HT, 12, BW.BW20, 2), 16), (Mod(F.VHT, 4, BW.BW20, 2), 16),
             (Mod(F.VHT, 9, BW.BW80, 2), 16), (Mod(F.HT, 15, BW.BW40, 2), 8)]


@pytest.mark.parametrize("mod,n_sym", MIMO_MODS)
def test_mimo_decoder_buffers_are_the_tables(mod, n_sym):
    dec = MimoDataDecoder(port_mod(mod), n_sym, "zf")
    b = {k: v.numpy() for k, v in dec.named_buffers()}
    assert not any(True for _ in dec.parameters())
    for iss in range(2):
        np.testing.assert_array_equal(b["rx_perm"][iss],
                                      ilv.rx_perm(mod, iss))
    ss_idx, pos_idx = jmimo._deparser_gather(mod)
    np.testing.assert_array_equal(b["deparse_idx"],
                                  ss_idx * mod.nCBPSS + pos_idx)
    assert b["deparse_idx"].shape[0] == mod.nES
    pidx0 = 3 if mod.fmt == F.HT else 4
    pref = (np.stack([jdemod.pilot_refs(mod, n_sym, pidx0, iss)
                      for iss in range(2)]) if mod.fmt == F.HT
            else jdemod.pilot_refs(mod, n_sym, pidx0))
    np.testing.assert_array_equal(b["pilot_ref"], pref.astype(np.float32))
    pts, masks = jdemod._ml_candidates(mod.mod)
    np.testing.assert_array_equal(b["ml_pts"], pts)
    np.testing.assert_array_equal(b["ml_masks"], masks)
    np.testing.assert_array_equal(
        b["ltf_ref_nl"], jdemod.ltf_ref_grid(mod.bw, False).astype(
            np.complex64))
    jdec = jmimo.MimoDataDecoder(mod, n_sym, "zf")
    assert (dec.data_offset(), dec.zlen(), dec.window_capacity()) == (
        jdec.data_offset(), jdec.zlen(), jdec.window_capacity())


@pytest.mark.parametrize("mod", [Mod(F.L, 3), Mod(F.HT, 5),
                                 Mod(F.VHT, 7, BW.BW80, 1)])
def test_mrc_decoder_geometry_equals_jax(mod):
    dec, jdec = MrcDataDecoder(port_mod(mod), 16), jmimo.MrcDataDecoder(mod,
                                                                        16)
    assert (dec.data_offset(), dec.zlen(), dec.window_capacity()) == (
        jdec.data_offset(), jdec.zlen(), jdec.window_capacity())


def test_decoders_are_cached_per_device_and_detector():
    mod, mrc = port_mod(Mod(F.VHT, 4, BW.BW20, 2)), port_mod(Mod(F.HT, 5))
    cpu = torch.device("cpu")
    assert get_mimo_decoder(mod, 16, "ml", "cpu") is get_mimo_decoder(
        mod, 16, "ml", cpu)
    assert get_mimo_decoder(mod, 16, "zf", "cpu").detector == "zf"
    assert get_mrc_decoder(mrc, 16, "cpu") is get_mrc_decoder(mrc, 16, cpu)


def test_cpu_receiver_launches_no_kernel():
    before = (kv.LAUNCHES, kg.LAUNCHES, kg.SHARED_LAUNCHES,
              kg.MULTI_LAUNCHES)
    cap, want = _dual(False)
    res = MimoReceiver(device="cpu").decode_capture(cap)
    assert sum(r.fcs_ok for r in res) == len(want)
    assert (kv.LAUNCHES, kg.LAUNCHES, kg.SHARED_LAUNCHES,
            kg.MULTI_LAUNCHES) == before


def test_options_are_checked():
    rx = MimoReceiver(mu_pos=1, mu_gid=7, device="cpu")
    assert (rx.mu_pos, rx.mu_gid, rx.detector) == (1, 7, "auto")
    with pytest.raises(NotImplementedError, match="device trigger"):
        MimoReceiver(trigger="device", device="cpu")
    with pytest.raises(ValueError):
        MimoReceiver(detector="mmse", device="cpu")
    with pytest.raises(ValueError):
        MimoDataDecoder(port_mod(Mod(F.VHT, 4)), 16)
    with pytest.raises(ValueError):
        MimoDataDecoder(port_mod(Mod(F.VHT, 4, BW.BW20, 2)), 16,
                        detector="auto")
    with pytest.raises(ValueError):
        MimoReceiver(device="cpu").decode_capture(np.zeros(1000, np.complex64))
