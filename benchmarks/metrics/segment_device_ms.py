"""Device busy time (union of the traced operation intervals) per library
call, ms."""


def read(view):
    tr = view["trace"]
    calls = len(view["records"])
    if tr is None or not calls:
        return None
    return tr.busy_s() / calls * 1e3
