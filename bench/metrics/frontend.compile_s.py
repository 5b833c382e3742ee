"""frontend.compile_s: seconds of the set-up's ``compile_network`` call,
from the benchmark's span around it (source: program_span)."""


def read(run):
    return run.spans.total("frontend.compile") or None
