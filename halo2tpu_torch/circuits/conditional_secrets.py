"""Conditional-secrets (Identity) circuit: selective attribute reveal.

Re-design of anon-aadhaar-halo2/src/conditional_secrets.rs:9-295: one row,
20 advice columns (10 scalars + 5 state bytes + 5 qr_data_state bytes),
one selector, and the reference's 7 gate groups:

  - booleanity r*(r-1) for each of the 4 reveal flags
    (conditional_secrets.rs:102-109,119-123,132-136,145-149)
  - age:      age_above_18 - reveal_age * qr_data_age_above_18 == 0  (:111-117)
  - gender:   gender - qr_data_gender == 0 (UNconditional, :125-130)
  - pincode:  pincode - qr_data_pincode == 0 (UNconditional, :138-143)
  - state[i]: state[i] - qr_data_state[i] == 0 x5 (UNconditional, :151-170)

The reference only gates the *age* equality on its reveal flag — a quirk we
reproduce by default.  `gated_reveals=True` applies the age-style gating
(field - reveal*qr_field == 0) to gender/pincode/state as the apparent
intent of the reveal flags.
"""
from __future__ import annotations

from ..fields.bn254 import R
from ..plonk.circuit import Circuit, ConstraintSystem


SCALAR_COLS = [
    "reveal_age_above_18", "age_above_18", "qr_data_age_above_18",
    "reveal_gender", "gender", "qr_data_gender",
    "reveal_pincode", "pincode", "qr_data_pincode",
    "reveal_state",
]


class IdentityCircuit(Circuit):
    def __init__(self, reveal_age_above_18: bool, age_above_18: int,
                 qr_data_age_above_18: int, reveal_gender: bool, gender: int,
                 qr_data_gender: int, reveal_pincode: bool, pincode: int,
                 qr_data_pincode: int, reveal_state: bool, state: list[int],
                 qr_data_state: list[int], gated_reveals: bool = False):
        assert len(state) == 5 and len(qr_data_state) == 5
        self.w = dict(
            reveal_age_above_18=int(reveal_age_above_18),
            age_above_18=age_above_18,
            qr_data_age_above_18=qr_data_age_above_18,
            reveal_gender=int(reveal_gender), gender=gender,
            qr_data_gender=qr_data_gender,
            reveal_pincode=int(reveal_pincode), pincode=pincode,
            qr_data_pincode=qr_data_pincode,
            reveal_state=int(reveal_state),
        )
        self.state = state
        self.qr_data_state = qr_data_state
        self.gated = gated_reveals

    def configure(self, cs: ConstraintSystem):
        cols = {name: cs.advice_column() for name in SCALAR_COLS}
        state_cols = [cs.advice_column() for _ in range(5)]
        qr_state_cols = [cs.advice_column() for _ in range(5)]
        sel = cs.selector()
        s = cs.query_selector(sel)
        q = {name: cs.query_advice(c, 0) for name, c in cols.items()}

        for flag in ("reveal_age_above_18", "reveal_gender", "reveal_pincode",
                     "reveal_state"):
            cs.create_gate(f"{flag} boolean", s * q[flag] * (q[flag] - 1))

        cs.create_gate("ageAbove18 assignment",
                       s * (q["age_above_18"]
                            - q["reveal_age_above_18"] * q["qr_data_age_above_18"]))
        if self.gated:
            cs.create_gate("gender assignment",
                           s * (q["gender"] - q["reveal_gender"] * q["qr_data_gender"]))
            cs.create_gate("pincode assignment",
                           s * (q["pincode"] - q["reveal_pincode"] * q["qr_data_pincode"]))
            cs.create_gate("state assignment", [
                s * (cs.query_advice(a, 0) - q["reveal_state"] * cs.query_advice(b, 0))
                for a, b in zip(state_cols, qr_state_cols)])
        else:
            cs.create_gate("gender assignment", s * (q["gender"] - q["qr_data_gender"]))
            cs.create_gate("pincode assignment",
                           s * (q["pincode"] - q["qr_data_pincode"]))
            cs.create_gate("state assignment", [
                s * (cs.query_advice(a, 0) - cs.query_advice(b, 0))
                for a, b in zip(state_cols, qr_state_cols)])

        return {"cols": cols, "state": state_cols, "qr_state": qr_state_cols,
                "sel": sel}

    def synthesize(self, config, asn) -> None:
        asn.enable_selector(config["sel"], 0)
        for name, col in config["cols"].items():
            asn.assign_advice(col, 0, self.w[name] % R)
        for col, v in zip(config["state"], self.state):
            asn.assign_advice(col, 0, v % R)
        for col, v in zip(config["qr_state"], self.qr_data_state):
            asn.assign_advice(col, 0, v % R)

    def instances(self):
        return []
