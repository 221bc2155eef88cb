"""The tampered RSA-SHA256 k=15 mock prover's golden
(tests/golden/mock_k15_failures.json): halo2tpu's MockProver failure list,
from its C++ gate evaluator, for chip_smoke.rsa_circuit()'s circuit with
the advice cells of chip_smoke.MOCK_TAMPER overwritten after synthesis.
chip_smoke.py phase 8 holds the port's MockProver on the card to this list;
here the golden is held to those tamper constants and to the inputs
chip_smoke signs.

Run as a script, it computes the list again with halo2tpu alone (RSA at
k = 15 satisfied and tampered, then the composite Aadhaar circuit of
chip_smoke.composite_circuit() satisfied and with a wrong nullifier seed),
prints each part's wall time on this host, and exits non-zero unless the
tampered list equals the golden's.  It never writes the golden:
    JAX_PLATFORMS=cpu python tests/test_torch_mock_golden.py
"""
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests/golden/mock_k15_failures.json")


def _golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def test_mock_golden_is_chip_smokes_tamper():
    g = _golden()
    assert g["k"] == 15
    assert [tuple(t) for t in g["tamper"]] == list(chip_smoke.MOCK_TAMPER)
    assert g["message_sha256"] == hashlib.sha256(
        chip_smoke.RSA_MESSAGE).hexdigest()
    assert g["evaluator"] == "native"


def test_mock_golden_has_each_kind_and_names_the_tamper():
    """The tamper reaches a gate, a copy and a lookup, and the list stops
    short of the cap (so no kind is cut off by an early return)."""
    fails = _golden()["failures"]
    assert {f["kind"] for f in fails} == {"gate", "copy", "lookup"}
    assert len(fails) <= 16
    details = " ".join(f["detail"] for f in fails)
    for col, row, value in chip_smoke.MOCK_TAMPER:
        assert f"Column('advice', {col})[{row}]={value}" in details


def _halo2tpu_run(circuit, instances, tamper=()):
    """halo2tpu's MockProver at k = 15: (failures as dicts, synthesis s,
    verify s), the advice cells of `tamper` overwritten after synthesis."""
    from halo2tpu import native
    from halo2tpu.plonk.mock import MockProver
    assert native.available(), "halo2tpu's C++ evaluator did not build"
    t0 = time.perf_counter()
    mp = MockProver.run(15, circuit, instances)
    t1 = time.perf_counter()
    for col, row, value in tamper:
        mp.asn.advice[col][row] = value
    fails = mp.verify()
    t2 = time.perf_counter()
    return ([{"kind": f.kind, "detail": f.detail} for f in fails], t1 - t0,
            t2 - t1)


def main() -> int:
    from test_torch_composite_golden import \
        _halo2tpu_circuit as composite_circuit
    from test_torch_rsa_golden import _halo2tpu_circuit as rsa_circuit
    c = rsa_circuit()
    ok, synth, verify = _halo2tpu_run(c, c.instances())
    print(f"rsa k=15 satisfied: {len(ok)} failures, synthesis {synth:.2f} "
          f"s, verify {verify:.2f} s")
    fails, synth, verify = _halo2tpu_run(c, c.instances(),
                                         chip_smoke.MOCK_TAMPER)
    print(f"rsa k=15 tampered: {len(fails)} failures, synthesis "
          f"{synth:.2f} s, verify {verify:.2f} s")
    g = _golden()
    new = dict(g, tamper=[list(t) for t in chip_smoke.MOCK_TAMPER],
               message_sha256=hashlib.sha256(
                   chip_smoke.RSA_MESSAGE).hexdigest(), failures=fails)
    print(json.dumps(new, indent=1))
    same = new == g
    print("the golden's list" if same else "differs from the golden")
    c = composite_circuit()
    inst = c.instances()
    comp, synth, verify = _halo2tpu_run(c, inst)
    print(f"composite k=15 satisfied: {len(comp)} failures, synthesis "
          f"{synth:.2f} s, verify {verify:.2f} s")
    bad = [list(inst[0])]
    bad[0][0] ^= 1
    wrong, synth, verify = _halo2tpu_run(c, bad)
    print(f"composite k=15 nullifier_seed ^ 1: {len(wrong)} failures, "
          f"synthesis {synth:.2f} s, verify {verify:.2f} s")
    return 0 if same and not ok and not comp and wrong else 1


if __name__ == "__main__":
    sys.exit(main())
