"""Telemetry: device-side wire/drop/shadow counters (:mod:`counters`), the
host-side span tracer with Chrome-trace export (:mod:`trace`), pluggable
metrics sinks (:mod:`sink`), the modeled-vs-measured StepStats record
(:mod:`stats`) and the resilience layer's incident-event vocabulary
(:mod:`events`), as the JAX package's ``repro/obs`` has them.

:mod:`trace`, :mod:`sink` and :mod:`events` use the standard library and
numpy only, so ``repro_torch.core`` may import them without cycles.
"""
from repro_torch.obs import events  # noqa: F401
from repro_torch.obs import trace  # noqa: F401
from repro_torch.obs.counters import ObsCounters  # noqa: F401
from repro_torch.obs.sink import (CsvSink, JsonlSink, MemorySink,  # noqa: F401
                                  MetricsSink, MultiSink, jsonl_records)
from repro_torch.obs.stats import (StepStats,  # noqa: F401
                                   modeled_collective_bytes)
