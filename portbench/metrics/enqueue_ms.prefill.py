"""Host milliseconds from the call of the prefill step until it returns,
before the synchronise, averaged over the window's forwards: the host's
share of a forward while the card still works."""


def read(r):
    if not r.enqueue_s:
        return None
    return 1e3 * sum(r.enqueue_s) / len(r.enqueue_s)
