"""What the CUDA-tensor guard in the port's serializer costs a Serve request.

Where torch is loaded, `cluster_anywhere_tpu_torch.core.serialization`
pickles through Pickler subclasses whose `reducer_override` refuses a CUDA
tensor, in place of plain `pickle.dumps`.  This script times `serialize()`
of what one HTTP request of the `serve-http` cell sends over the runtime
(the proxy's `Request` with a 441-token JSON body, and the replica's answer
dict), with the guard and without it, in one process on the host's CPU.

    python3 scripts/torch_serialize_cost.py [--number N] [--repeat R]

Prints one JSON object: microseconds a call, the best of R rounds of N calls.
"""

import argparse
import json
import os
import sys
import timeit

import torch  # noqa: F401  (loaded, as in every replica: the guard is on)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from cluster_anywhere_tpu_torch.core import serialization
from cluster_anywhere_tpu_torch.serve.proxy import Request


def _values():
    body = json.dumps({"prompt": "x" * 441, "max_tokens": 32, "temperature": 0.0}).encode()
    request = Request("POST", "/llm", {}, {"content-type": "application/json"}, body)
    answer = {"text": "y" * 32, "num_tokens": 32, "finish_reason": "length"}
    return {"request": ((request,), {}), "answer": answer}


def _best_us(fn, number, repeat):
    return min(timeit.repeat(fn, number=number, repeat=repeat)) / number * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--number", type=int, default=20000)
    ap.add_argument("--repeat", type=int, default=7)
    args = ap.parse_args()
    assert serialization._guarded_picklers() is not None, "the guard is not on"
    out = {}
    for name, value in _values().items():
        guarded = _best_us(lambda: serialization.serialize(value), args.number, args.repeat)
        guard = serialization._guarded_picklers
        serialization._guarded_picklers = lambda: None  # the path taken without torch
        try:
            plain = _best_us(lambda: serialization.serialize(value), args.number, args.repeat)
        finally:
            serialization._guarded_picklers = guard
        out[name] = {"guarded_us": guarded, "plain_us": plain, "added_us": guarded - plain}
    print(json.dumps({"serialize_us": out}))


if __name__ == "__main__":
    main()
