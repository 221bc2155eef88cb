"""Tracing of the prover (SURVEY §5.1): the phase seconds a caller sums
through `tracer=`, and one in-memory record of each traced proof.

    tr = Tracer()
    create_proof(pk, srs, circuit, instances, engine=eng, tracer=tr)
    tr.phases              # {"synthesize": s, "advice_ntt": s, ...}
    rec = recent()[-1]     # that proof's Record: spans and counters

A proof given a tracer opens a Record (`proof()`), held in a ContextVar
while the proof runs: `current()` returns it, or NULL_RECORD, whose
`span` and `count` do nothing, when no traced proof is running.  Each of
the prover's phases goes to the caller's tracer (`phase(name)`, nothing
else) and becomes a span of the record; the steps inside and between the
phases are spans of the record alone, each annotated with
torch.profiler.record_function so that it lies on the profiler's clock.
In a traced proof every span ends in the engine's synchronize, so its
host time (start to host_end) and its wait on the device (host_end to
end) are apart.  Finished records go to a bounded log, `recent()`.
"""
from __future__ import annotations

import contextvars
import itertools
import time
from collections import defaultdict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

from torch.profiler import record_function

RECENT = 512        # records kept by recent()


class Tracer:
    """Each phase's seconds (perf_counter), summed over the proofs this
    tracer is passed to."""

    def __init__(self):
        self.phases: dict[str, float] = defaultdict(float)

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] += time.perf_counter() - start


class NullTracer:
    """No-op stand-in so that keygen can trace unconditionally."""

    @contextmanager
    def phase(self, name: str):
        yield


NULL = NullTracer()


@dataclass(slots=True)
class Span:
    name: str
    parent: int | None      # index of the enclosing span in Record.spans
    start: float            # time.perf_counter()
    host_end: float | None = None   # before the span's synchronize
    end: float | None = None


class Record:
    """One traced proof: its request id, spans in the order they opened,
    and counters."""

    def __init__(self, request, outer, sync):
        self.request = request
        self.spans: list[Span] = []
        self.counters: dict[str, int] = defaultdict(int)
        self.start = time.perf_counter()
        self.end: float | None = None
        self._outer = outer
        self._sync = sync
        self._open: list[int] = []

    @contextmanager
    def _span(self, name: str, sync, annotate: bool):
        s = Span(name, self._open[-1] if self._open else None,
                 time.perf_counter())
        self._open.append(len(self.spans))
        self.spans.append(s)
        try:
            with record_function(name) if annotate else nullcontext():
                yield
                s.host_end = time.perf_counter()
                sync()
        finally:
            s.end = time.perf_counter()
            if s.host_end is None:
                s.host_end = s.end
            self._open.pop()

    def span(self, name: str):
        """A step of the proof: a span of this record alone."""
        return self._span(name, self._sync, True)

    @contextmanager
    def phase(self, name: str, sync):
        """One of the prover's phases: the caller's tracer gets
        phase(name) (and annotates it if it will), the record a span."""
        with self._outer.phase(name), self._span(name, sync, False):
            yield

    def count(self, name: str, inc: int = 1) -> None:
        self.counters[name] += inc


class _NullRecord:
    """current() outside a traced proof: spans and counts do nothing; a
    phase still ends in the engine's synchronize, as every proof's does."""

    _noop = nullcontext()

    def span(self, name: str):
        return self._noop

    @contextmanager
    def phase(self, name: str, sync):
        yield
        sync()

    def count(self, name: str, inc: int = 1) -> None:
        pass


NULL_RECORD = _NullRecord()
_CURRENT = contextvars.ContextVar("halo2tpu_torch_trace_record",
                                  default=NULL_RECORD)
_RECENT: deque = deque(maxlen=RECENT)
_SEQ = itertools.count(1)


def current():
    """The running traced proof's Record, or NULL_RECORD."""
    return _CURRENT.get()


def recent() -> list:
    """The last RECENT finished records, oldest first."""
    return list(_RECENT)


@contextmanager
def proof(tracer, sync):
    """The record of one proof (NULL_RECORD when tracer is None), its
    request id this process's next sequence number.  The record is current
    until the proof ends, raised or not, and then goes to recent()."""
    if tracer is None:
        yield NULL_RECORD
        return
    rec = Record(next(_SEQ), tracer, sync)
    token = _CURRENT.set(rec)
    try:
        yield rec
    finally:
        rec.end = time.perf_counter()
        _CURRENT.reset(token)
        _RECENT.append(rec)
