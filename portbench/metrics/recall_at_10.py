"""recall_at_10: the share of the exact 10 nearest neighbours found, over the
window's answers to a sample of the query pool drawn from the seed
(``check.py``; ties at the tenth distance count)."""


def read(run):
    if run.k != 10 or run.verdict is None:
        return None
    return run.verdict.recall
