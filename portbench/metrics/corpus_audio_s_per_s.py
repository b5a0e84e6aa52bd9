"""Audio seconds encoded a second: every `encode_corpus` job started in the
window, whole files as bytes on the host, over the time from the window's
start to the last such job's end (host clock)."""

from portbench.readers import audio_rate as read  # noqa: F401
