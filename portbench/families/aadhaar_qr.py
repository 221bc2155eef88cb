"""Anon-Aadhaar's composite circuit: one proof of a whole QR (RSA-SHA256
over the signed prefix, field extraction, age, reveal flags, nullifier,
timestamp, signal).

A request is a fresh user's QR in the layout of UIDAI's secure QR code
(as `tests/golden/qr_msg.json`): "V2", then 17 text fields and the photo,
each after a 255 delimiter.  Its total length is the configuration's
`qr_bytes`: the circuit's layout depends on it, so one proving key serves
only QRs of that length; the photo takes what the text leaves.  The
fields' contents are drawn; what the reference needs to work the public
instances out again is kept under "truth".
"""
from __future__ import annotations

import calendar

from .common import load_signer, sign

LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
# text fields after "V2": (what, lengths); fixed ones are filled below
TEXT = [("email_mobile", None), ("reference", None), ("name", (6, 24)),
        ("dob", None), ("gender", None), ("care_of", (8, 24)),
        ("district", (4, 16)), ("landmark", (0, 20)), ("house", (3, 16)),
        ("location", (0, 20)), ("pincode", None), ("post_office", (4, 16)),
        ("state", None), ("street", (0, 24)), ("subdistrict", (4, 16)),
        ("vtc", (4, 16)), ("mobile_last4", None)]
JP2_START = b"\xff\x4f\xff\x51"     # a JPEG 2000 codestream's first marker


def run_context(mix, config, rng) -> dict:
    """One signer (UIDAI's stand-in) and one nullifier seed (one app) per
    run."""
    return {"signer": load_signer(config["signer"]),
            "nullifier_seed": rng.getrandbits(253)}


def _words(rng, lo, hi) -> bytes:
    n = rng.randint(lo, hi)
    out = []
    while len(out) < n:
        out.append(" " if out and out[-1] != " " and rng.random() < 0.15
                   else rng.choice(LETTERS))
    return "".join(out[:n]).strip().ljust(n, "a").encode()


def make_request(rng, mix, config, ctx, sizes) -> dict:
    year = rng.randint(*mix["qr_years"])
    month = rng.randint(1, 12)
    day = rng.randint(1, calendar.monthrange(year, month)[1])
    hour, minute, second = rng.randint(0, 23), rng.randint(0, 59), \
        rng.randint(0, 59)
    byear = year - rng.randint(*mix["age_years"])
    bmonth = rng.randint(1, 12)
    bday = rng.randint(1, calendar.monthrange(byear, bmonth)[1])
    gender = rng.choice(mix["genders"])
    pincode = rng.randint(110000, 855999)
    state = rng.choice(mix["states"]).encode()
    fixed = {
        "email_mobile": str(rng.randint(0, 3)).encode(),
        "reference": (f"{rng.randint(0, 9999):04d}{year:04d}{month:02d}"
                      f"{day:02d}{hour:02d}{minute:02d}{second:02d}"
                      f"{rng.randint(0, 999):03d}").encode(),
        "dob": f"{bday:02d}-{bmonth:02d}-{byear:04d}".encode(),
        "gender": gender.encode(), "pincode": str(pincode).encode(),
        "state": state, "mobile_last4": f"{rng.randint(0, 9999):04d}".encode(),
    }
    fields = {k: fixed[k] if span is None else _words(rng, *span)
              for k, span in TEXT}
    # the text (with "V2" and 18 delimiters) takes text_bytes: pad or trim
    # the free address lines
    want = sizes["text_bytes"]
    free = [k for k, span in TEXT if span is not None]
    have = 2 + 18 + sum(len(v) for v in fields.values())
    if not 2 + 18 + sum(len(fixed[k]) for k in fixed) + len(free) <= want:
        raise ValueError(f"text_bytes {want} below the fixed fields")
    i = 0
    while have != want:
        k = free[i % len(free)]
        if have < want:
            fields[k] += rng.choice(LETTERS).encode()
            have += 1
        elif len(fields[k]) > 1:
            fields[k] = fields[k][:-1]
            have -= 1
        i += 1
    photo_len = config["qr_bytes"] - want
    photo = JP2_START + rng.randbytes(photo_len - len(JP2_START))
    qr = b"V2" + b"".join(b"\xff" + fields[k] for k, _ in TEXT) + b"\xff" \
        + photo
    assert len(qr) == config["qr_bytes"]
    signed_len = sizes["signed_bytes"]
    reveal = {k: rng.random() < mix["reveal_share"]
              for k in ("age", "gender", "pincode", "state")}
    return {
        "qr": qr, "signed_len": signed_len,
        "sig": sign(ctx["signer"], qr[:signed_len]),
        "n": ctx["signer"]["n"], "nullifier_seed": ctx["nullifier_seed"],
        "signal_hash": rng.getrandbits(253), "reveal": reveal,
        "truth": {"year": year, "month": month, "day": day, "hour": hour,
                  "byear": byear, "bmonth": bmonth, "bday": bday,
                  "gender": gender, "pincode": pincode, "state": state,
                  "photo": photo},
    }


def circuit(config, request, classes):
    """The circuit of request, built from `classes`: the program's module
    (halo2tpu_torch.circuits.aadhaar_qr) or the reference's copy."""
    w = classes.AadhaarWitness(
        request["qr"], request["n"], request["sig"],
        nullifier_seed=request["nullifier_seed"],
        signal_hash=request["signal_hash"],
        reveal_age=request["reveal"]["age"],
        reveal_gender=request["reveal"]["gender"],
        reveal_pincode=request["reveal"]["pincode"],
        reveal_state=request["reveal"]["state"],
        signed_len=request["signed_len"])
    return classes.AadhaarQRVerifierCircuit(
        w, classes.AadhaarParams(**config["params"]))


def program_circuit(config, request):
    from halo2tpu_torch.circuits import aadhaar_qr
    return circuit(config, request, aadhaar_qr)
