"""The port's copy of the MAC layer (ieee80211_tpu_torch/mac/) builds the
same bytes as the JAX package's ieee80211_tpu/mac/: UDP MPDUs, data,
management and control frames, HT and VHT A-MPDUs, and it deaggregates and
parses them alike, with the native runtime and without it.
"""
import dataclasses

import numpy as np
import pytest

from ieee80211_tpu import mac as jmac
from ieee80211_tpu_torch import mac
import torch_parity  # noqa: F401  (caps torch's threads)

ADDRS = dict(addr1="f4:69:d5:80:0f:a0", addr2="00:c0:ca:b1:5b:e1",
             addr3="f4:69:d5:80:0f:a0")


def _configs():
    return [dict(), dict(subtype=8, seq=2704, **ADDRS),
            dict(ftype=2, to_ds=0, from_ds=1, retry=1, seq=4095, qos=5,
                 duration=44, **ADDRS),
            dict(subtype=8, protected=1, seq=17, **ADDRS)]


def _payloads(seed):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, int(n), dtype=np.uint8))
            for n in (0, 1, 25, 300, 1500)]


def _as_dicts(subframes):
    return [dataclasses.asdict(s) for s in subframes]


@pytest.mark.parametrize("k", range(4))
def test_udp_mpdus_equal_jax(k):
    cfg = mac.MacConfig(**_configs()[k])
    jcfg = jmac.MacConfig(**_configs()[k])
    for body in _payloads(k):
        got = mac.build_udp_mpdu(body, cfg)
        assert got == jmac.build_udp_mpdu(body, jcfg)
        assert mac.build_udp_mpdu(body, cfg, "192.168.1.2", "192.168.1.9",
                                  5000, 6000, 7, 3) == jmac.build_udp_mpdu(
            body, jcfg, "192.168.1.2", "192.168.1.9", 5000, 6000, 7, 3)
        assert mac.build_data_frame(body, cfg) == jmac.build_data_frame(
            body, jcfg)
        assert (dataclasses.asdict(mac.parse_mpdu(got))
                == dataclasses.asdict(jmac.parse_mpdu(got)))
        assert (dataclasses.asdict(mac.parse_udp_mpdu(got))
                == dataclasses.asdict(jmac.parse_udp_mpdu(got)))


def test_encapsulation_equals_jax():
    for body in _payloads(9):
        assert mac.build_llc(body) == jmac.build_llc(body)
        assert mac.build_llc(body, 0x86DD) == jmac.build_llc(body, 0x86DD)
        assert mac.build_ipv4(body, 7, 64, "10.0.0.1", "10.0.0.2") == (
            jmac.build_ipv4(body, 7, 64, "10.0.0.1", "10.0.0.2"))
        assert mac.build_udp(body, "10.0.0.1", "10.0.0.2", 1, 2) == (
            jmac.build_udp(body, "10.0.0.1", "10.0.0.2", 1, 2))


@pytest.mark.parametrize("n_mpdus", [1, 2, 5])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_aggregation_and_deaggregation_equal_jax(n_mpdus, native,
                                                 monkeypatch):
    if not native:   # the pure-python walk both packages fall back to
        import ieee80211_tpu.native as jnat
        import ieee80211_tpu_torch.native as nat
        monkeypatch.setattr(nat, "deagg", lambda *a, **k: None)
        monkeypatch.setattr(jnat, "deagg", lambda *a, **k: None)
    cfg = mac.MacConfig(subtype=8, **ADDRS)
    jcfg = jmac.MacConfig(subtype=8, **ADDRS)
    bodies = _payloads(n_mpdus)[:n_mpdus]
    mpdus = [mac.build_udp_mpdu(b, cfg) for b in bodies]
    assert mpdus == [jmac.build_udp_mpdu(b, jcfg) for b in bodies]
    for agg, deagg in (("aggregate_ht", "deaggregate_ht"),
                       ("aggregate_vht", "deaggregate_vht")):
        psdu = getattr(mac, agg)(mpdus)
        assert psdu == getattr(jmac, agg)(mpdus)
        got = getattr(mac, deagg)(psdu)
        assert _as_dicts(got) == _as_dicts(getattr(jmac, deagg)(psdu))
        assert [s.mpdu for s in got] == mpdus
        assert all(s.fcs_ok for s in got)
        bad = bytearray(psdu)
        bad[len(bad) // 2] ^= 0x40          # one flipped bit mid-PSDU
        assert _as_dicts(getattr(mac, deagg)(bytes(bad))) == _as_dicts(
            getattr(jmac, deagg)(bytes(bad)))
        assert _as_dicts(getattr(mac, deagg)(psdu, 1)) == _as_dicts(
            getattr(jmac, deagg)(psdu, 1))


def test_management_and_control_frames_equal_jax():
    pairs = [
        ("build_beacon", ("lab-ssid", ADDRS["addr2"], ADDRS["addr3"], 12,
                          123456789, 100, 0x1111, 36)),
        ("build_element", (221, b"\x00\x50\xf2\x02")),
        ("build_bf_report_poll", (ADDRS["addr1"], ADDRS["addr2"], [0, 1])),
        ("build_mgmt_action_no_ack", (ADDRS["addr1"], ADDRS["addr2"],
                                      ADDRS["addr3"], 9, 21, b"\x01\x02")),
        ("build_vht_ndp_announcement", (ADDRS["addr1"], ADDRS["addr2"], 3,
                                        [1, 2], [0, 1], [0, 1])),
    ]
    for name, args in pairs:
        got = getattr(mac, name)(*args)
        assert got == getattr(jmac, name)(*args), name
        if name != "build_element":
            assert (dataclasses.asdict(mac.parse_frame(got))
                    == dataclasses.asdict(jmac.parse_frame(got))), name
    body = mac.build_element(0, b"lab") + mac.build_element(3, b"\x24")
    assert ([dataclasses.asdict(e) for e in mac.parse_mgmt_elements(body)]
            == [dataclasses.asdict(e)
                for e in jmac.parse_mgmt_elements(body)])
