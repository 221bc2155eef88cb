"""The Signal (Square) circuit: out = signal^2, out public.  Small enough
to prove on a CPU: the harness's own tests run whole cells of it."""
from __future__ import annotations


def run_context(mix, config, rng) -> dict:
    return {}


def make_request(rng, mix, config, ctx, sizes) -> dict:
    return {"signal": rng.getrandbits(mix["signal_bits"])}


def circuit(config, request, classes):
    return classes.SquareCircuit(request["signal"], constrain_instance=True)


def program_circuit(config, request):
    from halo2tpu_torch.circuits import signal
    return circuit(config, request, signal)
