"""Prompt tokens a second: the prompt tokens (pads not counted) of every
request the window completed, through its token on the host, over the
whole window."""


def read(run):
    if not run.items:
        return None
    return sum(it["prompt_tokens"] for it in run.items) / run.window_s
