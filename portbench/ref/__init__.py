"""The benchmark's plain reference: what decides `correct`.

It imports nothing of the program (`halo2tpu_torch`) and nothing of JAX.
The subpackages `fields`, `ops`, `plonk`, `gadgets`, `circuits` and
`curves` are frozen copies of the port's host modules (pure Python: the
field constants, Keccak and Poseidon, the constraint-system IR, the
gadgets and circuits), so that a later change to the program cannot move
the yardstick.  `keys` works the verifying key out again from the
circuit, with the dev SRS's tau in place of any multi-scalar
multiplication; `verify` checks a proof's bytes against a key and the
public instances; `families/<family>.py` computes each request's public
instances from the fields the traffic generator drew, independently of
the circuit that parses them.
"""
