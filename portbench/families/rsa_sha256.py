"""RSA-SHA256 signature verification: sha256(msg) = H and sig^e =
pkcs1v15(H) mod n, over messages of up to the circuit's max_msg_len bytes
(one key serves every length).  A request is a fresh message of random
bytes signed by the run's one signer."""
from __future__ import annotations

from .common import load_signer, sign


def run_context(mix, config, rng) -> dict:
    return {"signer": load_signer(config["signer"])}


def make_request(rng, mix, config, ctx, sizes) -> dict:
    msg = rng.randbytes(sizes["msg_bytes"])
    return {"msg": msg, "n": ctx["signer"]["n"],
            "sig": sign(ctx["signer"], msg)}


def circuit(config, request, classes):
    return classes.RSASha256Circuit(
        request["msg"], request["n"], request["sig"],
        classes.RSASha256Params(**config["params"]))


def program_circuit(config, request):
    from halo2tpu_torch.circuits import rsa_sha256
    return circuit(config, request, rsa_sha256)
