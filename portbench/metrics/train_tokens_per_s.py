"""train_tokens_per_s (tokens/s, host clock): batch x (encoder + decoder
length) tokens of every step of the window, over the window, the device
synchronised at both ends."""


def read(rec):
    if "tokens" not in rec:
        return None
    return rec["tokens"] / rec["window_s"]
