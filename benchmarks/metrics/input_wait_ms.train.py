"""Host time the trainer waits in each next() of its batch iterator (the
prefetch queue over the dataset's decode), ms per step."""


def read(view):
    waits = [w for r in view["records"] for w in r.get("input_waits", [])]
    return sum(waits) / len(waits) * 1e3 if waits else None
