"""Serving namespace: the LM decode loop. (The reference's ER match
service, ``ERService``, is ROADMAP Queue 1 item 9.)"""
from .decode import generate, make_decode_step, make_prefill  # noqa: F401
