"""The mean of ``generate_sentence``'s ``t_frontend`` (the prompt's and the
text's preparation on the host), over the window's unprofiled calls."""


def read(rec):
    calls = rec.get("offline_calls")
    if not calls:
        return None
    return sum(c["t_frontend"] for c in calls) / len(calls) * 1e3
