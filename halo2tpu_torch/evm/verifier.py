"""EVM acceptance of the UNCHANGED reference verifier contract; a copy of
halo2tpu/evm/verifier.py over the port's own modules.

Runs the reference `contract.sol` at CONTRACT_PATH (the environment
variable HALO2TPU_CONTRACT, else the reference checkout's path; PSE
halo2-solidity-verifier output for the Square/signal circuit) against proof
bytes produced by this framework, via the Yul interpreter (evm/yul.py):

  - the Solidity constant declarations (contract.sol:6-66) are parsed and
    injected as Yul-scope constants,
  - the `assembly {}` body of verifyProof (contract.sol:72-827) is executed
    with EVM semantics,
  - the separate vk contract is reproduced as a bytecode blob in the PSE
    layout the contract reads via extcodecopy (contract.sol:222,308):
    header words at fixed offsets, then fixed commitments, then permutation
    (sigma) commitments — offsets decoded from the VK_MPTR memory map
    (contract.sol:14-36) and the commitment fold walk (contract.sol:739-747),
  - calldata is ABI-encoded verifyProof(address,bytes,uint256[]) so the
    hardcoded calldata pointers hold (PROOF_LEN_CPTR=0x64, PROOF_CPTR=0x84,
    NUM_INSTANCE_CPTR=0x04e4, contract.sol:6-9).
"""
from __future__ import annotations

import os
import re
from functools import lru_cache

from ..fields.bn254 import R, inv_mod
from .yul import Block, EvmRevert, Interpreter, Parser, tokenize

CONTRACT_PATH = os.environ.get(
    "HALO2TPU_CONTRACT",
    "/root/reference/solidity_verifier_contract/contract.sol")

VK_ADDRESS = 0x1000  # arbitrary nonzero address for the vk code blob


def _extract_assembly(src: str) -> str:
    """Return the body of the first `assembly { ... }` block."""
    start = src.index("assembly")
    start = src.index("{", start)
    depth = 0
    for i in range(start, len(src)):
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return src[start + 1:i]
    raise SyntaxError("unterminated assembly block")


_CONST_RE = re.compile(
    r"uint256\s+internal\s+constant\s+(\w+)\s*=\s*(0x[0-9a-fA-F]+|\d+)\s*;")


@lru_cache(maxsize=4)
def load_contract(path: str = CONTRACT_PATH):
    """Parse the contract once: (constants dict, parsed assembly Block)."""
    with open(path) as f:
        src = f.read()
    consts = {name: int(val, 0) for name, val in _CONST_RE.findall(src)}
    body = _extract_assembly(src)
    program = Parser(tokenize(body)).parse_program()
    return consts, program


def build_vk_code(vk, srs) -> bytes:
    """vk contract bytecode in the PSE halo2-solidity-verifier layout.

    Word offsets (mirroring the VK_MPTR..NEG_S_G2_Y_2_MPTR memory map,
    contract.sol:14-36, relative to VK_MPTR=0x0480):
      0x000 vk_digest         0x0e0 has_accumulator (0)
      0x020 num_instances     0x100-0x140 accumulator meta (0)
      0x040 k                 0x160 g1_x, 0x180 g1_y
      0x060 n_inv             0x1a0-0x200 g2 (x_c1, x_c0, y_c1, y_c0)
      0x080 omega             0x220-0x280 -s_g2 (same order)
      0x0a0 omega_inv         0x2a0... fixed comms, then sigma comms
      0x0c0 omega_inv^(b+1)
    """
    from ..curves.pairing import g2_neg

    d = vk.domain
    b = vk.cs.blinding_factors()
    num_instances = sum(vk.num_instance_rows)
    omega_inv = inv_mod(d.omega, R)
    words: list[int] = [
        vk.transcript_repr,
        num_instances,
        vk.k,
        inv_mod(d.n, R),
        d.omega,
        omega_inv,
        pow(omega_inv, b + 1, R),
        0, 0, 0, 0,                      # has_accumulator, acc meta
        srs.g[0][0], srs.g[0][1],        # [1]_1
    ]
    g2 = srs.g2
    neg_s_g2 = g2_neg(srs.s_g2)
    for p2 in (g2, neg_s_g2):
        (x0, x1), (y0, y1) = p2          # x = x0 + x1*u
        words += [x1, x0, y1, y0]        # EIP-197: imaginary first
    for c in list(vk.fixed_commitments) + list(vk.permutation_commitments):
        if c is None:
            words += [0, 0]
        else:
            words += [c[0], c[1]]
    return b"".join(w.to_bytes(32, "big") for w in words)


def encode_calldata(vk_addr: int, proof: bytes, instances: list[int]) -> bytes:
    """ABI: verifyProof(address vk, bytes proof, uint256[] instances)."""
    selector = bytes.fromhex("af3e8a10")  # value irrelevant to the assembly
    head = (vk_addr.to_bytes(32, "big")
            + (0x60).to_bytes(32, "big")                       # proof offset
            + (0x60 + 32 + ((len(proof) + 31) // 32) * 32
               ).to_bytes(32, "big"))                          # instances offset
    proof_part = len(proof).to_bytes(32, "big") + proof
    if len(proof) % 32:
        proof_part += b"\x00" * (32 - len(proof) % 32)
    inst_part = len(instances).to_bytes(32, "big") + b"".join(
        (v % (1 << 256)).to_bytes(32, "big") for v in instances)
    return selector + head + proof_part + inst_part


def evm_verify(vk, srs, instances: list[list[int]], proof: bytes,
               contract_path: str = CONTRACT_PATH) -> bool:
    """Execute the unchanged contract against the proof.  True iff
    verifyProof returns 1 (contract.sol:825-826); reverts map to False."""
    consts, program = load_contract(contract_path)
    flat = [v for col in instances for v in col]
    calldata = encode_calldata(VK_ADDRESS, proof, flat)
    vk_code = build_vk_code(vk, srs)
    # `vk` is the first function arg: the contract references it by name
    # inside the assembly; bind it as a constant.
    consts = dict(consts)
    consts["vk"] = VK_ADDRESS
    interp = Interpreter(program, calldata,
                         code_registry={VK_ADDRESS: vk_code},
                         constants=consts)
    try:
        ret = interp.run()
    except EvmRevert:
        return False
    return len(ret) == 32 and int.from_bytes(ret, "big") == 1
