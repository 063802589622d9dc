"""The share of ``generate_sentence``'s ``t`` (sampling and vocoding) that
is ``t_vocoder``, summed over the window's unprofiled calls."""


def read(rec):
    calls = rec.get("offline_calls")
    if not calls:
        return None
    total = sum(c["t"] for c in calls)
    if total <= 0:
        return None
    return 100.0 * sum(c["t_vocoder"] for c in calls) / total
