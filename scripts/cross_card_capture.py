"""Can one CUDA graph hold work on two cards?  The question behind the
eager mode of a sharded pod whose members span devices
(``serving/graphs.py``, ``RoundGraph(eager=True)``).

Two bodies are captured on card 0's stream, each moving a tensor to
card 1, multiplying it there and bringing the product back, the shape
of a pod round's gathers: ``naive`` (card 1's work on card 1's current
stream) and ``forked`` (on a card-1 side stream that waits on the
capturing stream and is joined back by it).  Each runs in a process of
its own, since a failed capture can leave the CUDA context unusable,
and reports whether its capture raised and, if not, whether a replay
equals the eager body before and after its input changes.

Usage (a machine with two cards or more):
  python3 scripts/cross_card_capture.py
"""

from __future__ import annotations

import subprocess
import sys
import textwrap

BODIES = {
    "naive": """
        y1 = x0.to(d1) @ w1
        out.copy_(y1.to(d0))
    """,
    "forked": """
        cap = torch.cuda.current_stream(d0)
        s1.wait_stream(cap)
        with torch.cuda.stream(s1):
            y1 = x0.to(d1) @ w1
        cap.wait_stream(s1)
        out.copy_(y1.to(d0))
    """,
}

PROGRAM = """
import torch
d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
torch.manual_seed(0)
x0 = torch.randn(64, 256, device=d0)
w1 = torch.randn(256, 256, device=d1)
out = torch.zeros(64, 256, device=d0)
s1 = torch.cuda.Stream(d1)

def body():
{body}

def sync():
    torch.cuda.synchronize(d0)
    torch.cuda.synchronize(d1)

body(); sync()
want = out.clone()
graph = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(graph):
        body()
except Exception as e:
    print("capture raised", type(e).__name__, str(e).splitlines()[0])
    raise SystemExit(3)
out.zero_()
graph.replay(); sync()
print("replay == eager:", torch.equal(out, want))
x0.mul_(2.0)
graph.replay(); sync()
print("replay after the input doubled == 2 x eager:",
      torch.allclose(out, 2 * want, rtol=1e-3, atol=1e-3))
"""


def main() -> int:
    import torch
    if torch.cuda.device_count() < 2:
        print("needs two cards or more", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name, body in BODIES.items():
        code = PROGRAM.format(body=textwrap.indent(textwrap.dedent(body),
                                                   "    "))
        run = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120)
        lines = (run.stdout + run.stderr).strip().splitlines()
        print(f"{name}: exit {run.returncode}; "
              + "; ".join(line for line in lines
                          if line.startswith(("capture", "replay"))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
