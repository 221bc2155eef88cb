"""The port's EVM verifier (halo2tpu_torch/evm/{yul,verifier}.py, copies
of halo2tpu's; tests/test_torch_copies.py holds their syntax trees) against
halo2tpu's on the CPU: the vk code of the Square k=4 key and the calldata
of the golden Square proof byte for byte, and one Yul program through both
interpreters (memory, keccak256, calldata and the 0x05-0x08 precompiles,
a pairing check that holds and one that fails) with the same return bytes,
and a revert in both.

The twin of tests/test_evm_verifier.py runs the port's TorchEngine proof
through the unchanged reference contract, read from CONTRACT below
(tests/golden/contract.sol in the repository, or the file that
HALO2TPU_CONTRACT names); it skips while that file is absent."""
import json
import os

import pytest
import torch

from halo2tpu.circuits.signal import SquareCircuit as JSquare
from halo2tpu.evm import verifier as jverifier
from halo2tpu.evm import yul as jyul
from halo2tpu.plonk.keygen import keygen as jkeygen
from halo2tpu.plonk.srs import setup as jsetup
from halo2tpu_torch.circuits.signal import SquareCircuit
from halo2tpu_torch.evm import verifier, yul
from halo2tpu_torch.evm.verifier import (VK_ADDRESS, build_vk_code,
                                         encode_calldata, evm_verify)
from halo2tpu_torch.fields.bn254 import G2_GEN_X, G2_GEN_Y, Q, R
from halo2tpu_torch.plonk.keygen import keygen
from halo2tpu_torch.plonk.prover import create_proof
from halo2tpu_torch.plonk.srs import setup
from halo2tpu_torch.plonk.verifier import verify_proof

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_port_proofs.json")
# the unchanged reference Solidity verifier, inside the repository
CONTRACT = os.environ.get(
    "HALO2TPU_CONTRACT",
    os.path.join(os.path.dirname(__file__), "golden", "contract.sol"))


@pytest.fixture(scope="module")
def square_key():
    """The port's Square k=4 key on the CPU and its SRS."""
    srs = setup(4)
    pk, vk = keygen(SquareCircuit(5), 4, srs, device="cpu")
    return srs, pk, vk


def test_vk_code_equals_halo2tpu(square_key):
    srs, _, vk = square_key
    jsrs = jsetup(4)
    _, jvk = jkeygen(JSquare(5), 4, jsrs)
    code = build_vk_code(vk, srs)
    assert code == jverifier.build_vk_code(jvk, jsrs)
    # the contract's 0x3a0-byte extcodecopy (contract.sol:308)
    assert len(code) >= 0x03a0
    assert int.from_bytes(code[:32], "big") == vk.transcript_repr


def test_calldata_of_golden_proof_equals_halo2tpu():
    with open(GOLDEN) as f:
        proof = bytes.fromhex(json.load(f)["square_k4"]["proof"])
    inst = [v for col in SquareCircuit(5).instances() for v in col]
    data = encode_calldata(VK_ADDRESS, proof, inst)
    assert data == jverifier.encode_calldata(jverifier.VK_ADDRESS, proof,
                                             inst)
    # selector, three head words, the proof's length word and bytes, the
    # instances' length word and values
    assert len(data) == 4 + 3 * 32 + 32 + len(proof) + 32 + 32 * len(inst)


# memory, mstore8 and keccak256; modexp 3^e mod m; G1 + G1 and 2 * G1; two
# pairing checks of two pairs each, from calldata words: (G1, G2), (-G1,
# G2), which holds, and (G1, G2), (G1, G2), which fails.  Returns the
# 0x400 bytes of memory holding every result, and reverts unless every
# call succeeded.
YUL_PROGRAM = """
mstore(0x00, calldataload(0x00))
mstore8(0x20, 0xab)
mstore(0x40, keccak256(0x00, 0x21))
mstore(0x80, 0x20)
mstore(0xa0, 0x20)
mstore(0xc0, 0x20)
mstore(0xe0, 3)
mstore(0x100, calldataload(0x20))
mstore(0x120, calldataload(0x40))
let ok := staticcall(gas(), 0x05, 0x80, 0xc0, 0x60, 0x20)
mstore(0x200, calldataload(0x60))
mstore(0x220, calldataload(0x80))
mstore(0x240, calldataload(0x60))
mstore(0x260, calldataload(0x80))
ok := and(ok, staticcall(gas(), 0x06, 0x200, 0x80, 0x280, 0x40))
mstore(0x300, calldataload(0x60))
mstore(0x320, calldataload(0x80))
mstore(0x340, 2)
ok := and(ok, staticcall(gas(), 0x07, 0x300, 0x60, 0x2c0, 0x40))
mstore(0x380, eq(mload(0x280), mload(0x2c0)))
for { let i := 0 } lt(i, 0x300) { i := add(i, 0x20) } {
    mstore(add(0x400, i), calldataload(add(0xa0, i)))
}
ok := and(ok, staticcall(gas(), 0x08, 0x400, 0x180, 0x3a0, 0x20))
ok := and(ok, staticcall(gas(), 0x08, 0x580, 0x180, 0x3c0, 0x20))
mstore(0x3e0, ok)
if iszero(ok) { revert(0, 0) }
return(0x00, 0x400)
"""


def _word(v: int) -> bytes:
    return v.to_bytes(32, "big")


def _pair(p1, negate: bool) -> bytes:
    """A pairing input pair: G1 point p1 (negated or not) and the G2
    generator, imaginary parts first (EIP-197)."""
    x, y = p1
    (x0, x1), (y0, y1) = G2_GEN_X, G2_GEN_Y
    return b"".join(map(_word, (x, (Q - y) % Q if negate else y,
                                x1, x0, y1, y0)))


def _calldata(exponent: int) -> bytes:
    g1 = (1, 2)
    return (_word(0x1234) + _word(exponent) + _word(R) + _word(g1[0])
            + _word(g1[1]) + _pair(g1, False) + _pair(g1, True)
            + _pair(g1, False) + _pair(g1, False))


def _run(mod, src: str, calldata: bytes) -> bytes:
    program = mod.Parser(mod.tokenize(src)).parse_program()
    return mod.Interpreter(program, calldata).run()


def test_yul_program_equals_halo2tpu():
    data = _calldata(R - 2)
    out = _run(yul, YUL_PROGRAM, data)
    assert out == _run(jyul, YUL_PROGRAM, data)
    assert len(out) == 0x400
    word = {off: int.from_bytes(out[off:off + 32], "big")
            for off in range(0, 0x400, 0x20)}
    assert word[0x60] == pow(3, R - 2, R)
    assert word[0x380] == 1 and word[0x280] != 0   # G1 + G1 == 2 G1
    assert (word[0x3a0], word[0x3c0], word[0x3e0]) == (1, 0, 1)


def test_yul_revert_in_both():
    src = "if calldataload(0) { revert(0, 0) } mstore(0, 7) return(0, 32)"
    assert _run(yul, src, _word(0)) == _run(jyul, src, _word(0)) == _word(7)
    with pytest.raises(yul.EvmRevert):
        _run(yul, src, _word(1))
    with pytest.raises(jyul.EvmRevert):
        _run(jyul, src, _word(1))
    # a failing precompile call (a G1 point off the curve) returns 0
    bad = YUL_PROGRAM.replace("calldataload(0x80))\nok := and(ok, "
                              "staticcall(gas(), 0x06",
                              "add(calldataload(0x80), 1))\nok := and(ok, "
                              "staticcall(gas(), 0x06")
    assert bad != YUL_PROGRAM
    with pytest.raises(yul.EvmRevert):
        _run(yul, bad, _calldata(5))
    with pytest.raises(jyul.EvmRevert):
        _run(jyul, bad, _calldata(5))


def test_evm_modules_are_the_ports():
    """The copies run on the port's modules: the verifier's interpreter is
    the port's yul, and nothing of them names halo2tpu."""
    assert verifier.Interpreter is yul.Interpreter
    assert verifier.EvmRevert is yul.EvmRevert
    assert jverifier.Interpreter is not yul.Interpreter


# -- the twin of tests/test_evm_verifier.py -----------------------------------

@pytest.fixture(scope="module")
def square_proof(square_key):
    if not os.path.exists(CONTRACT):
        pytest.skip(f"reference contract.sol not at {CONTRACT}")
    srs, pk, vk = square_key
    circuit = SquareCircuit(5)  # reference vector, signal.rs:92
    proof = create_proof(pk, srs, circuit, circuit.instances(), rng_seed=0,
                         device="cpu")
    assert verify_proof(vk, srs, circuit.instances(), proof)
    return srs, vk, circuit, proof


def test_contract_accepts_port_proof(square_proof):
    srs, vk, circuit, proof = square_proof
    assert len(proof) == 0x0460  # contract.sol:226 hardcoded length check
    assert evm_verify(vk, srs, circuit.instances(), proof,
                      contract_path=CONTRACT)


def test_contract_rejects_tampered_proof(square_proof):
    srs, vk, circuit, proof = square_proof
    for pos in (3, 200, 700, 1100):
        bad = bytearray(proof)
        bad[pos] ^= 1
        assert not evm_verify(vk, srs, circuit.instances(), bytes(bad),
                              contract_path=CONTRACT)


def test_contract_rejects_wrong_instances(square_proof):
    srs, vk, circuit, proof = square_proof
    assert not evm_verify(vk, srs, [[7]], proof, contract_path=CONTRACT)


def test_contract_rejects_wrong_length(square_proof):
    srs, vk, circuit, proof = square_proof
    assert not evm_verify(vk, srs, circuit.instances(), proof + b"\x00" * 32,
                          contract_path=CONTRACT)
    assert not evm_verify(vk, srs, circuit.instances(), proof[:-32],
                          contract_path=CONTRACT)
