"""Every prefill's wall in the window over the thousands of prompt tokens
the prefills computed (batch x padded prompt length)."""


def read(run):
    tokens = sum(s.batch.tokens.size for s in run.served)
    return sum(s.prefill_s for s in run.served) * 1e3 / (tokens / 1e3) if tokens else None
