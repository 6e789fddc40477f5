"""Tokens completed over the whole window, migrations included: tokens
generated by the serving replica, or the tokens of the batches trained
(each batch id once, its replay not again)."""


def read(rec):
    if rec.tokens_per_batch:
        n = len(rec.trained) * rec.tokens_per_batch
    else:
        n = sum(1 for toks in rec.served.values()
                for t, _ in toks if 0.0 <= t <= rec.window_s)
    return n / rec.window_s
