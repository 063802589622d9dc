"""Faults planted under the timed path for the benchmark's own tests, each
a function that breaks the port in this process."""


def state_unchanged():
    """Every Euler step returns its state unchanged."""
    from zipvoice_torch.models import solver

    solver.euler_step = lambda velocity_fn, x, *a, **kw: x.float()


def half_batch():
    """The second half of each sampled batch is left out: its rows return
    the first half's."""
    from zipvoice_torch.infer.pipeline import InferencePipeline

    orig = InferencePipeline._sample_device

    def broken(self, *a, **kw):
        x1_wo, lens = orig(self, *a, **kw)
        n = x1_wo.shape[0]
        if n > 1:
            x1_wo, lens = x1_wo.clone(), lens.clone()
            x1_wo[n // 2:] = x1_wo[:n - n // 2]
            lens[n // 2:] = lens[:n - n // 2]
        return x1_wo, lens

    InferencePipeline._sample_device = broken


def token_altered():
    """One text token of every row is changed where the pipeline prepares
    the batch."""
    from zipvoice_torch.infer.pipeline import InferencePipeline

    orig = InferencePipeline._sample_batch_device

    def broken(self, batch_tokens, *a, **kw):
        rows = [list(t) for t in batch_tokens]
        for row in rows:
            row[len(row) // 2] = (row[len(row) // 2] + 7) % 300 + 1
        return orig(self, rows, *a, **kw)

    InferencePipeline._sample_batch_device = broken


def answer_altered():
    """Every sampled row's generated frames come out in reverse order,
    where they are produced."""
    from zipvoice_torch.infer.pipeline import InferencePipeline

    orig = InferencePipeline._sample_device

    def broken(self, *a, **kw):
        x1_wo, lens = orig(self, *a, **kw)
        x1_wo = x1_wo.clone()
        for i, n in enumerate(lens.tolist()):
            x1_wo[i, :n] = x1_wo[i, :n].flip(0)
        return x1_wo, lens

    InferencePipeline._sample_device = broken
