"""The closed loop that drives a serving entry: ``batch`` sequences in
lockstep, each round a new request a sequence.

A round starts every sequence at position ``context`` with a first token
drawn from the seed and decodes ``output_tokens`` greedy tokens; each
step's B tokens are copied to the host, as a server that streams them
does, and the host time of that arrival is the step's clock.  The next
round starts at the same position over the same contexts: the entries a
round wrote past the context are masked by the position (the program's
decode state has one position for the batch).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from . import inputs


class ClosedLoop:
    def __init__(self, entry: Any, conf: Dict[str, Any], traffic: Dict[str, Any], seed: int,
                 device, caches) -> None:
        self.entry, self.conf, self.traffic, self.seed = entry, conf, traffic, seed
        self.device = torch.device(device)
        self.state = {"pos": None, **caches}
        self.rounds: List[Dict[str, Any]] = []
        self.k = traffic["output_tokens"]          # steps done in the current round
        self.tok = None

    @property
    def pos(self) -> int:
        """Position of the next step's new token."""
        return self.traffic["context"] + (self.k % self.traffic["output_tokens"])

    def _start_round(self) -> None:
        first = inputs.first_tokens(self.conf, self.traffic, self.seed, len(self.rounds))
        self.rounds.append({"first": first, "served": []})
        self.state["pos"] = torch.tensor(self.traffic["context"], dtype=torch.int32,
                                         device=self.device)
        self.tok = first.to(self.device)
        self.k = 0

    def step(self) -> float:
        """One decode step of the batch; the host time its tokens arrived."""
        if self.k == self.traffic["output_tokens"]:
            self._start_round()
        logits, self.state = self.entry.step(self.state, self.tok)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        host = tok.cpu()
        t = time.perf_counter()
        self.rounds[-1]["served"].append(host)
        self.tok = tok[:, None]
        self.k += 1
        return t

    def window(self, seconds: float) -> Dict[str, Any]:
        """Steps for ``seconds`` of host time: the steps whose tokens
        arrived inside the window, their positions, and the gaps between
        arrivals (the first measured from the window's start)."""
        carried = int(self.k < self.traffic["output_tokens"])    # a round already under way
        r0 = len(self.rounds)
        t0 = time.perf_counter()
        end = t0 + seconds
        arrivals, positions = [], []
        while True:
            pos = self.pos
            t = self.step()
            if t > end:
                break
            arrivals.append(t)
            positions.append(pos)
        gaps = [b - a for a, b in zip([t0] + arrivals[:-1], arrivals)]
        return {"seconds": seconds, "steps": len(arrivals), "positions": positions,
                "gaps_s": gaps,
                "requests": self.traffic["batch"] * (len(self.rounds) - r0 + carried)}

    def finish_round(self) -> None:
        """Decode the current round to its end (untimed)."""
        while self.k < self.traffic["output_tokens"]:
            self.step()

    def requests(self, picks) -> Dict[str, torch.Tensor]:
        """The sampled requests ``(round, sequence)``: their slots, their
        input tokens (the first token, then each served token but the
        last) and their served tokens, (R, output_tokens) on the host."""
        served = [torch.stack(self.rounds[r]["served"], dim=1)[b] for r, b in picks]
        first = [self.rounds[r]["first"][b] for r, b in picks]
        served = torch.stack(served).to(torch.int64)
        tokens = torch.cat([torch.stack(first).to(torch.int64), served[:, :-1]], dim=1)
        return {"slots": torch.tensor([b for _, b in picks]), "tokens": tokens, "served": served}

    @property
    def finished_rounds(self) -> int:
        n = len(self.rounds)
        return n if self.k == self.traffic["output_tokens"] else n - 1
