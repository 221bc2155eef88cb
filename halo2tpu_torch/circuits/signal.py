"""Signal (Square) circuit: signal_hash binding / front-running protection.

Re-design of anon-aadhaar-halo2/src/signal.rs:15-85: two advice columns, one
selector, gate  s * (out - in^2)  (reference line 41), equality enabled on
both advice columns and the instance column.  The shipped Solidity verifier
corresponds to exactly this circuit (SURVEY §0.1, contract.sol:443-451).

The reference leaves the instance constraint commented out
(signal.rs:72); we expose both variants — `constrain_instance=True` realizes
the obvious intent (out copied to the public input).
"""
from __future__ import annotations

from ..fields.bn254 import R
from ..plonk.circuit import Circuit, ConstraintSystem


class SquareCircuit(Circuit):
    def __init__(self, signal_hash: int, constrain_instance: bool = False):
        self.signal_hash = signal_hash % R
        self.constrain_instance = constrain_instance

    def configure(self, cs: ConstraintSystem):
        advice = [cs.advice_column(), cs.advice_column()]
        instance = cs.instance_column()
        selector = cs.selector()

        cs.enable_equality(advice[0])
        cs.enable_equality(advice[1])
        cs.enable_equality(instance)

        s = cs.query_selector(selector)
        sig = cs.query_advice(advice[0], 0)
        sig_sq = cs.query_advice(advice[1], 0)
        cs.create_gate("square", s * (sig_sq - sig * sig))
        return {"advice": advice, "instance": instance, "selector": selector}

    def synthesize(self, config, asn) -> None:
        asn.enable_selector(config["selector"], 0)
        asn.assign_advice(config["advice"][0], 0, self.signal_hash)
        out = self.signal_hash * self.signal_hash % R
        asn.assign_advice(config["advice"][1], 0, out)
        if self.constrain_instance:
            asn.copy((config["advice"][1], 0), (config["instance"], 0))

    def instances(self):
        if self.constrain_instance:
            return [[self.signal_hash * self.signal_hash % R]]
        return [[self.signal_hash * self.signal_hash % R]]
