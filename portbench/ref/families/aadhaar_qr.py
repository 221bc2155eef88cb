"""The composite circuit's public instances, worked out from the fields
the generator drew (request["truth"]), not from the QR bytes the circuit
parses:

  [nullifier_seed, signal_hash, pubkey_hash, nullifier, timestamp,
   reveal_age * above18, reveal_gender * gender, reveal_pincode * pincode,
   reveal_state * state_packed]

as the circuit states them (circuits/aadhaar_qr.py's docstring): the
timestamp is the QR's date and hour in IST as UTC epoch seconds, minutes
and seconds dropped, with the day count of timestamp.rs, which takes the
days before each month from a common year's table, so that a date after
February of a leap year counts one day less than the calendar; the age is the circuit's rule, year - birth year -
1, and one more when the birthday falls later in the year than the QR's
date (conditional_secrets.rs); above18 is age > 18; gender its ASCII code;
the state's bytes little-endian; the nullifier Poseidon(seed, photo
zero-padded to max_photo, 31 bytes little-endian an element); pubkey_hash
Poseidon of the modulus's 32 limbs of 64 bits.
"""
from __future__ import annotations

import calendar
import datetime

from ..circuits import aadhaar_qr as classes
from ..ops.poseidon import hash_elements

IST = datetime.timezone(datetime.timedelta(hours=5, minutes=30))


def instances(config, request) -> list[list[int]]:
    t = request["truth"]
    p = config["params"]
    stamp = int(datetime.datetime(t["year"], t["month"], t["day"], t["hour"],
                                  tzinfo=IST).timestamp())
    if calendar.isleap(t["year"]) and t["month"] > 2:
        stamp -= 86400
    age = t["year"] - t["byear"] - 1
    if (t["bmonth"], t["bday"]) > (t["month"], t["day"]):
        age += 1
    photo = t["photo"] + bytes(p["max_photo"] - len(t["photo"]))
    packed = [int.from_bytes(photo[i:i + 31], "little")
              for i in range(0, p["max_photo"], 31)]
    nullifier = hash_elements([request["nullifier_seed"]] + packed)
    n = request["n"]
    pubkey_hash = hash_elements([(n >> (64 * i)) & ((1 << 64) - 1)
                                 for i in range(32)])
    state = int.from_bytes(t["state"], "little")
    rv = request["reveal"]
    return [[request["nullifier_seed"], request["signal_hash"], pubkey_hash,
             nullifier, stamp, int(age > 18) if rv["age"] else 0,
             ord(t["gender"]) if rv["gender"] else 0,
             t["pincode"] if rv["pincode"] else 0,
             state if rv["state"] else 0]]
