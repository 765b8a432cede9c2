"""The plain reference decodes the generator's packets (small sizes)."""
import numpy as np
import pytest

from phybench import gen, harness, ref, ref_mimo
from phybench.wifi.specs import BW, CR, F, Mod
from phybench.wifi.tx import golden

SEED = 2 ** 35 + 99


@pytest.mark.parametrize("cr", [CR.CR12, CR.CR23, CR.CR34, CR.CR56])
def test_viterbi_inverts_the_encoder(cr):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (3, 240))
    bits[:, -6:] = 0
    coded = np.stack([golden.bcc(b, cr) for b in bits])
    llr = (2.0 * coded - 1.0) * 0.7
    np.testing.assert_array_equal(ref.viterbi(llr, cr, 240), bits)


def test_bf16_rounds_to_8_bits():
    p = ref.Prec("bf16")
    assert p(np.float64(1.0 + 2 ** -9)) == 1.0
    assert p(np.float64(1.0 + 2 ** -7)) == 1.0 + 2 ** -7
    x = np.array([3.14159 + 2.71828j])
    assert abs(p(x)[0] - x[0]) < 0.02
    assert ref.Prec("f64")(x) is x


@pytest.mark.parametrize("int8", [False, True])
def test_reference_decodes_a_siso_stream(int8):
    t = dict(harness.traffic("stream_mcs_sweep"), captures_per_call=1,
             capture_samples=1 << 16, distinct_bursts=1)
    st = gen.make_stream(t, SEED)
    (n_trig, res), = ref.decode_captures(st.bursts[0], int8, ref.Prec())
    good = [r for r in res if r.fcs_ok]
    assert n_trig >= len(st.packets[0][0])
    assert [r.mpdus for r in good] == [p.mpdus for p in st.packets[0][0]]
    assert [(r.fmt, r.mcs) for r in good] == [
        (p.fmt, p.mcs) for p in st.packets[0][0]]
    cfo = np.array([r.cfo_hz for r in good])
    air = np.array([p.cfo_hz for p in st.packets[0][0]])
    assert np.max(np.abs(cfo - air)) < 2e3      # the estimate, at 30 dB


def test_reference_decodes_a_2x2_stream():
    t = dict(harness.traffic("stream_mixed"), captures_per_call=1,
             capture_samples=1 << 16, distinct_bursts=1)
    st = gen.make_stream(t, SEED)
    (_, res), = ref_mimo.decode_captures(st.bursts[0], True, ref.Prec())
    good = [r for r in res if r.fcs_ok]
    assert [r.mpdus for r in good] == [p.mpdus for p in st.packets[0][0]]
    assert {p.nss for p in st.packets[0][0]} == {1, 2}


def test_ml_retry_decodes_what_zf_decodes():
    """The exact max-log ML LLRs of a clean 2x2 packet decode it too."""
    t = dict(harness.traffic("stream_mixed"), captures_per_call=1,
             capture_samples=1 << 14, distinct_bursts=1,
             mix=[[["HT", [9], 2]]])
    st = gen.make_stream(t, SEED)
    cap = st.bursts[0][0]
    x = np.stack([ref.ingest_int8(c) for c in cap]).astype(np.complex128)
    xp = np.zeros((2, 1 << 15), np.complex128)
    xp[:, :x.shape[1]] = x
    t0 = ref_mimo.merge([ref.triggers(c) for c in cap])
    (i, pl), = ref_mimo.plan(ref_mimo.sig_fields(xp, t0, ref.Prec()),
                             cap.shape[1])[:1]
    for ml in (False, True):
        lp, _ = ref_mimo.demod_2x2(xp, np.array([pl.ltf]),
                                   np.array([pl.cfo]), pl.mod, pl.n_sym,
                                   ref.Prec(), ml=ml)
        bits = ref.descramble(ref.viterbi_pairs([lp])[0])
        psdu = np.packbits(bits[0, 16:16 + 8 * pl.psdu_len],
                           bitorder="little").tobytes()
        assert ref.assemble(F.HT, psdu, pl.ampdu) == (
            True, st.packets[0][0][0].mpdus)


def test_reference_decodes_batch_rows():
    t = dict(harness.traffic("batch_vht7"), rows=6, distinct_batches=1)
    b = gen.make_batch(t, SEED)
    out = ref.decode_rows(b.x[0], np.zeros(6, np.int64),
                          Mod(F.VHT, 7, BW.BW20, 1), b.n_sym, ref.Prec())
    for r, p in enumerate(b.packets[0]):
        psdu = np.packbits(out["bits"][r, 16:16 + 8 * b.psdu_len],
                           bitorder="little").tobytes()
        assert ref.assemble(F.VHT, psdu, True) == (True, p.mpdus)


def legacy_passing_a_sig_crc(seed: int = 5):
    """A capture [N] complex64 holding one legacy 6 Mbps packet of 500 B
    at 30 dB whose first two DATA symbols, read as HT-SIG or VHT-SIG-A
    bits, pass that field's CRC-8, and its MPDUs. A BPSK symbol's Q axis
    holds only noise, and HT-SIG takes both symbols' Q, VHT-SIG-A the
    second's: about 1 noise draw in 128 passes."""
    from phybench.wifi.mac import MacConfig
    cfg = MacConfig(subtype=8, seq=2704, **gen.MAC)
    rng = np.random.default_rng(seed)
    mp = gen._mpdus((500,), rng, cfg)
    w = gen._waveform("L", 0, 1, mp)[0] * 0.1875
    sigma = np.sqrt(np.mean(np.abs(w) ** 2) / 10 ** 3.0 / 2)
    for _ in range(2000):
        x = np.zeros(1 << 15, np.complex64)
        x[800:800 + len(w)] = w + sigma * (rng.normal(size=len(w))
                                           + 1j * rng.normal(size=len(w)))
        t0 = ref.triggers(x)
        meta = ref.sig_fields(x.astype(np.complex128), t0, ref.Prec())
        if meta["ht_ok"][0] or meta["vht_ok"][0]:
            return x, mp, meta
    raise AssertionError("no such noise draw in 2000")


def test_format_follows_the_constellations_not_a_crc():
    """A legacy packet whose DATA passes a SIG CRC-8 by chance is legacy:
    its two symbols after L-SIG are BPSK, where HT-SIG is QBPSK in both and
    VHT-SIG-A in the second."""
    x, mp, meta = legacy_passing_a_sig_crc()
    assert not meta["q_dom"][0].any()
    assert ref.sig_format(meta, 0) == (False, False)
    (_, res), = ref.decode_captures([x], False, ref.Prec())
    assert [(r.fmt, r.mcs, r.mpdus) for r in res if r.fcs_ok] == [
        ("L", 0, mp)]


def test_margin_is_wide_on_clean_llrs_and_narrow_on_a_tie():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (2, 240))
    bits[:, -6:] = 0
    coded = np.stack([golden.bcc(b, CR.CR12) for b in bits])
    llr = (2.0 * coded - 1.0) * 0.7
    llr[1, 100:220] = 0.0           # 60 steps erased: paths that tie
    (out,), (mg,) = ref.viterbi_pairs([ref.depuncture(llr, CR.CR12, 240)],
                                      margins=True)
    np.testing.assert_array_equal(out[0], bits[0])
    assert mg[0] > 1.0 and mg[1] < 1e-9
