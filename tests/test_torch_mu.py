"""The port's MU-MIMO sounding loop against the JAX package's, on the CPU:
the copies of the feedback math (ieee80211_tpu_torch/mu/feedback.py) and
of the BF report codec (mac/bf_report.py), and the station side
(mu/sounding.py).

The copies must give equal arrays and equal bytes. NDP captures: the LTF
windows within 1e-5 of JAX's (the CFO that rotates them is a float32 sum
of another order), CFO within 1e-6 rad/sample, SNR within
`torch_parity.snr_tol_db`. The decoders take radix-3 Viterbi tables here,
as the JAX decoder runs radix 3 on the CPU: MU SIG-B words and MU DATA bits
equal JAX's exactly, EVM SNR within 1e-3 dB (white noise at 30 dB). The
single-shot closed loops (2 and 4 users) decode the same packets as JAX.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ieee80211_tpu import mu as jmu
from ieee80211_tpu.mac import MacConfig, aggregate_vht, build_udp_mpdu
from ieee80211_tpu.mac import bf_report as jbf
from ieee80211_tpu.mu import sounding as jsnd
from ieee80211_tpu.ops import coding as jcoding
from ieee80211_tpu.ops import demod as jdemod
from ieee80211_tpu.ops import sync as jsync
from ieee80211_tpu.rx import SisoReceiver as JaxSisoReceiver
from ieee80211_tpu.rx import receiver as jrx
from ieee80211_tpu.rx.mimo import MimoReceiver as JaxMimoReceiver
from ieee80211_tpu.specs import BW, F, Mod, tables
from ieee80211_tpu.specs import interleaver as ilv
from ieee80211_tpu.specs.modulation import ppdu_params_aggregate
from ieee80211_tpu.tx import finalize, gen_ampdu, gen_ampdu_mu
from ieee80211_tpu.utils import c2r
from ieee80211_tpu_torch import mu
from ieee80211_tpu_torch.mac import bf_report
from ieee80211_tpu_torch.mu import sounding as snd
from ieee80211_tpu_torch.ops import sync as psync
from torch_parity import MAC, add_noise, port_mod, radix_tensors, snr_tol_db

CFG = MacConfig(ftype=2, subtype=8, to_ds=1, from_ds=0, retry=0, protected=0,
                seq=2704, **MAC)
LTF_TOL = 1e-5
CFO_TOL = 1e-6
EVM_TOL = 1e-3
GID = 2


def _ndp_captures(n_sts: int, seed: int):
    """tests/test_mu_mimo.py's sounding: an n_sts-stream NDP through a
    well-conditioned channel, one 1-antenna capture per station."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n_sts, n_sts)) + 1j * rng.standard_normal(
        (n_sts, n_sts))
    h += (2.0 if n_sts == 2 else 2.5) * np.eye(n_sts)
    ndp = gen_ampdu(b"", Mod(F.VHT, 0, BW.BW20, n_sts))
    cap = finalize(ndp.waveform, multiplier=0.3, cfo_hz=4000.0, gap=True,
                   gap_len=1200)
    caps = []
    for u in range(n_sts):
        nrng = np.random.default_rng(u)
        y = h[u] @ cap
        y = y + (nrng.standard_normal(y.shape)
                 + 1j * nrng.standard_normal(y.shape)) * 1e-4
        caps.append(y.astype(np.complex64))
    return h, caps


# ---------------------------------------------------------------------------
# the feedback and BF report copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sts,n_rx", [(2, 1), (2, 2), (4, 1)])
def test_feedback_copy_equals_jax(n_sts, n_rx):
    rng = np.random.default_rng(3 + n_sts + n_rx)
    n_ltf = tables.N_LTF[n_sts]
    ltf_iq = (rng.standard_normal(n_ltf * 64)
              + 1j * rng.standard_normal(n_ltf * 64))
    np.testing.assert_array_equal(mu.ndp_ltf_channel(ltf_iq, n_sts),
                                  jmu.ndp_ltf_channel(ltf_iq, n_sts))
    ltf_sym = (rng.standard_normal((n_rx * n_ltf, 52))
               + 1j * rng.standard_normal((n_rx * n_ltf, 52)))
    v = mu.vht_channel_feedback(ltf_sym, BW.BW20, n_sts, n_rx)
    np.testing.assert_array_equal(
        v, jmu.vht_channel_feedback(ltf_sym, BW.BW20, n_sts, n_rx))
    for codebook in (0, 1):
        for vk in v[:6]:
            got, want = mu.compress_v(vk, codebook), jmu.compress_v(
                vk, codebook)
            assert got[0] == want[0] and list(got[1]) == list(want[1])
            np.testing.assert_array_equal(
                mu.recover_v(n_sts, n_rx, got[0], codebook),
                jmu.recover_v(n_sts, n_rx, want[0], codebook))
    if n_rx == 1:
        users = [v] + [mu.vht_channel_feedback(
            rng.standard_normal((n_ltf, 52))
            + 1j * rng.standard_normal((n_ltf, 52)), BW.BW20, n_sts, 1)
            for _ in range(n_sts - 1)]
        for norm in (True, False):
            q56 = mu.zf_q(users, normalize=norm)
            np.testing.assert_array_equal(q56, jmu.zf_q(users,
                                                        normalize=norm))
            np.testing.assert_array_equal(mu.map_q_to_grid(q56),
                                          jmu.map_q_to_grid(q56))


def test_feedback_of_a_real_ndp_equals_jax():
    """The whole AP side of test_mu_mimo.py's loop on one NDP capture."""
    _, caps = _ndp_captures(2, 42)
    nc = jsnd.sta_capture_ndp(caps[0], n_sts=2)
    sym = mu.ndp_ltf_channel(nc.ltf_iq, n_sts=2)
    v = mu.vht_channel_feedback(sym, BW.BW20, 2, 1)
    np.testing.assert_array_equal(v, jmu.vht_channel_feedback(
        jmu.ndp_ltf_channel(nc.ltf_iq, n_sts=2), BW.BW20, 2, 1))
    vc = np.stack([mu.recover_v(2, 1, mu.compress_v(vk)[0]) for vk in v])
    np.testing.assert_array_equal(vc, np.stack(
        [jmu.recover_v(2, 1, jmu.compress_v(vk)[0]) for vk in v]))


@pytest.mark.parametrize("codebook,group", [(1, 1), (0, 2), (1, 4)])
def test_bf_report_copy_equals_jax(codebook, group):
    rng = np.random.default_rng(9 + group)
    h = rng.standard_normal((56, 1, 2)) + 1j * rng.standard_normal((56, 1, 2))
    v = np.stack([np.linalg.svd(hk, full_matrices=False)[2].conj().T * -1
                  for hk in h])                           # [56, 2, 1]
    body = bf_report.build_vht_compressed_bf_action(
        v, [20.0], group=group, codebook=codebook, token=23)
    assert body == jbf.build_vht_compressed_bf_action(
        v, [20.0], group=group, codebook=codebook, token=23)
    assert bf_report.build_bf_report(v, [12.5], group, codebook) == \
        jbf.build_bf_report(v, [12.5], group, codebook)
    assert bf_report.build_mimo_control(2, 1, BW.BW20, group, codebook, 1,
                                        5) == jbf.build_mimo_control(
        2, 1, BW.BW20, group, codebook, 1, 5)
    vr, info = bf_report.parse_vht_compressed_bf_action(body)
    jvr, jinfo = jbf.parse_vht_compressed_bf_action(body)
    np.testing.assert_array_equal(vr, jvr)
    assert info == jinfo
    assert bf_report.BFFB_SCIDX_20 == jbf.BFFB_SCIDX_20


# ---------------------------------------------------------------------------
# single-shot station side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sts", [2, 4])
def test_sta_capture_ndp_equals_jax(n_sts):
    _, caps = _ndp_captures(n_sts, 42 if n_sts == 2 else 77)
    for cap in caps[:2]:
        got = snd.sta_capture_ndp(cap, n_sts=n_sts, device="cpu")
        want = jsnd.sta_capture_ndp(cap, n_sts=n_sts)
        assert set(dataclasses.asdict(got)) == set(dataclasses.asdict(want))
        assert got.ltf_iq.shape == want.ltf_iq.shape == (
            tables.N_LTF[n_sts] * 64,)
        np.testing.assert_allclose(got.ltf_iq, want.ltf_iq, rtol=0,
                                   atol=LTF_TOL)
        assert abs(got.cfo_rad - want.cfo_rad) <= CFO_TOL
        assert abs(got.snr_db - want.snr_db) <= snr_tol_db(want.snr_db)
    # a capture without an NDP: no record
    su = finalize(gen_ampdu(aggregate_vht([build_udp_mpdu(b"x" * 40, CFG)]),
                            Mod(F.VHT, 3)).waveform, multiplier=0.3,
                  gap=True, gap_len=600)[0].astype(np.complex64)
    assert snd.sta_capture_ndp(su, device="cpu") is None
    assert jsnd.sta_capture_ndp(su) is None


def _mu_ppdu(mpdus, mcss, q, gid=GID, bw=BW.BW20):
    tx = gen_ampdu_mu([aggregate_vht([m]) for m in mpdus],
                      [Mod(F.VHT, m, bw, 1) for m in mcss], bfq=q,
                      group_id=gid)
    return tx


def test_mu_sta_decoder_bits_equal_jax():
    """bench.py's MU-STA row at a small batch: MuStaDecoder on windows of
    a 2-user PPDU (identity Q, the station hears chain 0), radix 3 in both
    packages: the same bits, the STA's exact MPDU."""
    rng = np.random.default_rng(4)
    mpdus = [build_udp_mpdu(bytes(rng.integers(0, 256, 200, dtype=np.uint8)),
                            CFG) for _ in range(2)]
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (64, 1, 1))
    tx = _mu_ppdu(mpdus, [4, 4], qi)
    wave = finalize(tx.waveform, multiplier=0.2, cfo_hz=-9000.0, gap=True,
                    gap_len=64)
    mod = Mod(F.VHT, 4, BW.BW20, 1)
    pp = ppdu_params_aggregate(mod, len(aggregate_vht([mpdus[0]])))
    n_sym, psdu_len = pp.n_sym, pp.psdu_len
    w = 192 + 448 + 160 + 80 + 80 * n_sym + 80
    x = np.zeros(w, np.complex64)
    seg = add_noise(wave[0], 30.0, seed=5)[64 - 8:]
    x[:min(w, len(seg))] = seg[:min(w, len(seg))]
    x2 = np.tile(c2r(x)[None], (3, 1, 1))
    t0 = np.zeros(3, np.int32)
    ls, cfo, _ = (np.asarray(a) for a in jsync.sync_front_iq(
        jnp.asarray(x2), jnp.asarray(t0)))
    want = jsnd.MuStaDecoder(mod, n_sym, psdu_len, 0).decode(
        jnp.asarray(x2), jnp.asarray(ls), jnp.asarray(cfo))
    dec = snd.MuStaDecoder(port_mod(mod), n_sym, psdu_len, 0)
    dec.vit_w0, dec.vit_w1 = radix_tensors(3)
    got = dec.decode(torch.from_numpy(x2), torch.from_numpy(ls.copy()),
                     torch.from_numpy(cfo.copy()))
    np.testing.assert_array_equal(got, want)
    psdu = np.packbits(got[0, 16:16 + psdu_len * 8].astype(np.uint8),
                       bitorder="little").tobytes()
    from ieee80211_tpu.mac import deaggregate_vht
    subs = deaggregate_vht(psdu)
    assert subs and subs[0].fcs_ok and subs[0].mpdu == mpdus[0]


def test_mu_tables_equal_jax_helpers():
    mod = Mod(F.VHT, 5, BW.BW40, 1)
    t = snd.mu_sta_tables_from_numpy(port_mod(mod), 16, 1, 3)
    np.testing.assert_array_equal(t["vit_w0"], jcoding._radix_tables(4)[0])
    wr, wi = jdemod._dft_mats(128)
    np.testing.assert_array_equal(t["dft_re"], wr)
    np.testing.assert_array_equal(t["dft_im"], wi)
    np.testing.assert_array_equal(
        t["ltf_ref"], jdemod.ltf_ref_grid(BW.BW40, False).astype(np.complex64))
    np.testing.assert_array_equal(t["p_row"], tables.P_LTF_4[:3, :4][1])
    np.testing.assert_array_equal(
        t["pilot_ref"], jdemod.pilot_refs(mod, 16, 4).astype(np.float32))
    np.testing.assert_array_equal(t["rx_perm"], ilv.rx_perm(mod, 0))
    np.testing.assert_array_equal(t["prbs"],
                                  jcoding._prbs_tiled(16 * mod.nDBPS))
    np.testing.assert_array_equal(t["data_idx"],
                                  tables.DATA_GRID[(BW.BW40, False)])
    for q, bw in ((1, BW.BW20), (4, BW.BW80)):
        s = snd.mu_sigb_tables_from_numpy(q, 3, 4)
        np.testing.assert_array_equal(
            s["sigb_perm"], ilv.rx_perm(Mod(F.VHT, 0, bw, 1)))
        assert s["sigb_sign"].item() == tables.P_SIGB_NSTS478[3] == -1.0
        assert len(s["info_w"]) == jsnd.MU_SIGB_LEN[bw] + 4
    assert snd.mu_sigb_tables_from_numpy(1, 1, 2)["sigb_sign"].item() == 1.0
    assert snd.MU_SIGB_LEN == jsnd.MU_SIGB_LEN
    assert snd.MU_SIGB_INFO == jsnd.MU_SIGB_INFO
    dec = snd.MuStaDataDecoder(port_mod(mod), 16, 1, 3)
    ref = jsnd.MuStaDataDecoder(mod, 16, 1, 3)
    assert (dec.zlen(), dec.window_capacity(), dec.data_offset()) == (
        ref.zlen(), ref.window_capacity(), ref.data_offset())
    assert not any(True for _ in dec.parameters())


# ---------------------------------------------------------------------------
# the streaming lanes: SIG-B words and DATA bits
# ---------------------------------------------------------------------------


def _lane_capture(nrx: int, bw: BW, seed: int):
    """Five 2-user MU PPDUs of group GID (user 0 at MCS 0-4, user 1 at MCS
    2; identity Q, the station hears chain 0 on every RX chain) between
    silences, white noise at 30 dB. Returns (capture [N] or [nRx, N],
    the station's MPDUs)."""
    rng = np.random.default_rng(seed)
    nfft = tables.NFFT[bw]
    q = nfft // 64
    qi = np.tile(np.eye(2, dtype=np.complex64)[None], (nfft, 1, 1))
    g = np.array([0.9 - 0.2j, 0.6 + 0.7j])[:nrx]
    parts, want = [], []
    for k in range(5):
        mpdus = [build_udp_mpdu(bytes(rng.integers(
            0, 256, int(rng.integers(60, 300)), dtype=np.uint8)), CFG)
            for _ in range(2)]
        tx = _mu_ppdu(mpdus, [k, 2], qi, bw=bw)
        w = finalize(tx.waveform, multiplier=0.2, cfo_hz=float(
            rng.uniform(-2e4, 2e4)) * q, gap=False)[0]
        parts += [np.zeros((nrx, 900 * q), np.complex64), g[:, None] * w]
        want.append(mpdus[0])
    parts.append(np.zeros((nrx, 900 * q), np.complex64))
    cap = add_noise(np.concatenate(parts, axis=1), 30.0, seed + 1)
    return (cap[0] if nrx == 1 else cap), want


def _lanes(nrx: int, bw: BW, seed: int):
    """Both packages' streaming MU lanes on the same inputs: the JAX
    receiver's planner gives the candidates, and the port's SIG-B words
    and DATA decodes run on the same padded float32 capture and rows.
    Returns (JAX words, port words, [(JAX out, port out, items)], mpdus)."""
    cap, mpdus = _lane_capture(nrx, bw, seed)
    fs = 20e6 * (tables.NFFT[bw] // 64)
    jr = (JaxMimoReceiver if nrx == 2 else JaxSisoReceiver)(
        sample_rate_hz=fs, mu_pos=0, mu_gid=GID, ingest="f32")
    t0s, cap_dev, scale, npad = jr._ingest(cap)
    meta = jr._parse_sigs(cap_dev, scale, npad, t0s)
    cands = jr._plan_mu_batch(cap.shape[-1], meta, len(t0s))
    assert len(cands) == 5
    pcap = torch.from_numpy(np.asarray(cap_dev, np.float32)
                            * np.float32(scale))
    (si, nt), = {(c.stream_idx, c.n_sts_tot) for _, c in cands}
    q = jr.q
    wlen = (272 + 448 + 80 * int(tables.N_LTF[nt]) + 160) * q
    t_abs = np.asarray([min(c.win_start, npad - wlen) for _, c in cands],
                       np.int32)
    ltf = np.asarray([c.ltf_start + c.win_start - t for (_, c), t in
                      zip(cands, t_abs)], np.int32)
    cfo = np.asarray([c.cfo for _, c in cands], np.float32)
    jwords = np.asarray(jsnd.mu_sigb_parse_capture(
        cap_dev, scale, jnp.asarray(t_abs), jnp.asarray(ltf),
        jnp.asarray(cfo), wlen=wlen, stream_idx=si, n_sts_total=nt, q=q))
    tabs = snd.MuSigbTables(q, si, nt)
    tabs.vit_w0, tabs.vit_w1 = radix_tensors(3)
    pwords = snd.mu_sigb_parse_capture(
        pcap, torch.from_numpy(t_abs), torch.from_numpy(ltf),
        torch.from_numpy(cfo), wlen, tabs).numpy()
    plans = jr._plan_mu_data([(cands, jnp.asarray(jwords))])
    groups = {}
    for i, p in plans:
        groups.setdefault((p.mod, jrx._bucket(p.n_sym)), []).append((i, p))
    outs = []
    for (mod, nb), items in groups.items():
        jdec = jsnd.get_mu_sta_data_decoder(mod, nb, si, nt)
        pdec = snd.MuStaDataDecoder(port_mod(mod), nb, si, nt)
        pdec.vit_w0, pdec.vit_w1 = radix_tensors(3)
        w = jdec.window_capacity()
        rows = np.asarray([[min(p.win_start, npad - w) for _, p in items],
                           [0] * len(items), [p.n_sym for _, p in items],
                           [p.sigb_crc for _, p in items]], np.int32)
        rows[1] = [p.ltf_start + p.win_start - t
                   for (_, p), t in zip(items, rows[0])]
        pc = np.asarray([p.cfo for _, p in items], np.float32)
        jout = [np.asarray(a) for a in jdec.decode_from_capture(
            cap_dev, scale, jnp.asarray(rows[0]), jnp.asarray(rows[1]),
            jnp.asarray(pc), jnp.asarray(rows[2]), jnp.asarray(rows[3]))]
        r = torch.from_numpy(rows)
        pout = [a.numpy() for a in pdec.decode_from_capture(
            pcap, r[0], r[1], torch.from_numpy(pc), r[2], r[3])]
        outs.append((jout, pout, items))
    return jwords, pwords, outs, mpdus


@pytest.mark.parametrize("nrx,bw", [(1, BW.BW20), (2, BW.BW20),
                                    (1, BW.BW40), (2, BW.BW80)])
def test_mu_lanes_equal_jax(nrx, bw):
    jwords, pwords, outs, mpdus = _lanes(nrx, bw, seed=30 + 3 * nrx + bw)
    assert pwords.dtype == np.int32
    np.testing.assert_array_equal(pwords, jwords)
    n_ok = 0
    for jout, pout, items in outs:
        np.testing.assert_array_equal(pout[0], jout[0])       # packed bits
        np.testing.assert_allclose(pout[1], jout[1], rtol=0, atol=EVM_TOL)
        np.testing.assert_array_equal(pout[2], jout[2])       # SIG-B CRC
        for j, (i, p) in enumerate(items):
            r = jrx.assemble_psdu(F.VHT, p.mod, pout[0][j, 2:2 + p.psdu_len]
                                  .tobytes(), True)
            n_ok += bool(pout[2][j] and r.fcs_ok
                         and r.mpdus == [mpdus[i]])
    assert n_ok == 5


# ---------------------------------------------------------------------------
# the single-shot closed loops
# ---------------------------------------------------------------------------


def _summary(res):
    return [(r.fmt, r.mcs, r.psdu, r.fcs_ok, r.mpdus, r.sigb_ok, r.mu)
            for r in res]


def test_closed_loop_2user_equals_jax():
    """tests/test_jax_tx.py's loop with the port end to end: NDP ->
    sta_capture_ndp -> feedback -> ZF Q -> MuTxPipeline -> sta_decode_mu,
    against the same loop in the JAX package."""
    from ieee80211_tpu_torch.tx import MuTxPipeline
    h, ncaps = _ndp_captures(2, 42)
    v_users = []
    for u in range(2):
        nc = snd.sta_capture_ndp(ncaps[u], n_sts=2, device="cpu")
        v_users.append(mu.vht_channel_feedback(
            mu.ndp_ltf_channel(nc.ltf_iq, n_sts=2), BW.BW20, 2, 1))
    q = mu.map_q_to_grid(mu.zf_q(v_users))
    m = [build_udp_mpdu(b"station zero secret 000", CFG),
         build_udp_mpdu(b"station one secret 111", CFG)]
    a = [aggregate_vht([x]) for x in m]
    mods = [port_mod(Mod(F.VHT, 2, BW.BW20, 1))] * 2
    tx = MuTxPipeline(mods, [len(x) for x in a], group_id=GID, device="cpu")
    out = tx.step([torch.from_numpy(np.frombuffer(x, np.uint8)[None].copy())
                   for x in a],
                  torch.from_numpy(c2r(q.astype(np.complex64)))).numpy()
    cap = finalize(out[0, ..., 0] + 1j * out[0, ..., 1], multiplier=0.3,
                   cfo_hz=-3000.0, gap=True, gap_len=1200)
    for u in range(2):
        rx = (h[u] @ cap).astype(np.complex64)
        res = snd.sta_decode_mu(rx, mupos=u, device="cpu")
        assert len(res) == 1 and res[0].fcs_ok and res[0].mpdus == [m[u]]
        assert _summary(res) == _summary(jsnd.sta_decode_mu(rx, mupos=u))


def test_closed_loop_4user_equals_jax():
    """tests/test_mu_mimo.py's 4-user group: a 4-antenna AP, a 4x4 ZF Q and
    per-user MCS; every station decodes its own MPDU as JAX does."""
    h, ncaps = _ndp_captures(4, 77)
    v_users = [mu.vht_channel_feedback(mu.ndp_ltf_channel(
        snd.sta_capture_ndp(c, n_sts=4, device="cpu").ltf_iq, n_sts=4),
        BW.BW20, 4, 1) for c in ncaps]
    q = mu.map_q_to_grid(mu.zf_q(v_users))
    mpdus = [build_udp_mpdu(f"packet for STA {u} {'x' * (10 + 7 * u)}"
                            .encode(), CFG) for u in range(4)]
    mcss = [0, 1, 2, 0]
    tx = _mu_ppdu(mpdus, mcss, q, gid=5)
    cap = finalize(tx.waveform, multiplier=0.3, cfo_hz=-3000.0, gap=True,
                   gap_len=1200)
    for u in range(4):
        nrng = np.random.default_rng(20 + u)
        y = h[u] @ cap
        y = (y + (nrng.standard_normal(y.shape)
                  + 1j * nrng.standard_normal(y.shape)) * 1e-4).astype(
                      np.complex64)
        res = snd.sta_decode_mu(y, mupos=u, device="cpu")
        assert len(res) == 1 and res[0].fcs_ok and res[0].mcs == mcss[u]
        assert res[0].mpdus == [mpdus[u]]
        assert _summary(res) == _summary(jsnd.sta_decode_mu(y, mupos=u))


def test_sta_decode_mu_skips_other_positions():
    """A 2-stream user's position and an absent one are not ours: nothing
    decodes, in both packages."""
    qi = np.tile(np.eye(3, dtype=np.complex64)[None], (64, 1, 1))
    mpdus = [build_udp_mpdu(b"two-stream user zero payload xx", CFG),
             build_udp_mpdu(b"one-stream user one payload yyy", CFG)]
    tx = gen_ampdu_mu([aggregate_vht([x]) for x in mpdus],
                      [Mod(F.VHT, 2, BW.BW20, 2), Mod(F.VHT, 0, BW.BW20, 1)],
                      bfq=qi, group_id=5)
    wave = finalize(tx.waveform, multiplier=0.25, gap=True, gap_len=1200)
    rx = (0.3 * wave[2]).astype(np.complex64)
    for pos, n in ((0, 0), (2, 0), (1, 1)):
        res = snd.sta_decode_mu(rx, mupos=pos, device="cpu")
        assert _summary(res) == _summary(jsnd.sta_decode_mu(rx, mupos=pos))
        assert sum(r.fcs_ok for r in res) == n
    assert psync.find_triggers_np(rx).tolist() == \
        jsync.find_triggers_np(rx).tolist()
