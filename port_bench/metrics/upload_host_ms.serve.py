"""Mean host ms of the program's ``odt.upload`` spans: the host-to-device
copy of each uint8 batch, from host memory the caller owns, on the trace's
host clock."""


def read(r):
    ranges = r.trace.spans.get("odt.upload") if r.trace is not None else None
    if not ranges:
        return None
    return sum(end - ts for ts, end, _ in ranges) / len(ranges) / 1e3
