"""The comparison that decides ``correct``.

Two numbers, each against the cell's limit:

* ``logit_gap`` — the served tokens against the plain float32 reference.
  A sample of the requests retired inside the window, drawn from the seed
  with the longest of them always in it, until it holds the traffic's
  ``sample_tokens`` served tokens: the reference runs once over each
  prompt with its served tokens (layer by layer, the sample as one padded
  batch), and at each served token's position reads how far that token's
  logit lies below the reference's best.  The widest such gap is the
  number.  The served tokens are the first one, from ``admit``'s prefill,
  and every one of the paged decode ticks.
* ``decisions_differing`` — every HEFT_RT decision of the timed call, the
  in-tick ones and the host events, against the plain HEFT_RT over the
  same queues, its registers carried from the call's starting registers
  by its own decisions: the count of decisions whose order, replicas,
  start or finish times or new registers differ in any bit.  Limit 0.

The reference runs after the window, once the program's state is freed.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.plainref import heft_rt
from bench.plainref.precision import PRECISIONS, no_tf32

ROW_BLOCK = 256      # logit rows at a time


def sample(run, sample_tokens: int) -> list[int]:
    """Requests retired in the window: the longest, then others in an
    order drawn from the seed, until ``sample_tokens`` served tokens."""
    done = sorted(r for r, (t, _) in run.retired.items()
                  if run.window_start < t <= run.window_end)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(run.retired[r][1]), -r))
    rest = [r for r in done if r != longest]
    rng = np.random.default_rng([run.seed, 1])
    picked, tokens = [longest], run.requests[longest][1]
    for r in rng.permutation(rest):
        if tokens >= sample_tokens:
            break
        picked.append(int(r))
        tokens += run.requests[int(r)][1]
    return picked


def sequences(run, picked: list[int]) -> list[tuple[np.ndarray, np.ndarray]]:
    """(prompt, served tokens) of each picked request, as retired."""
    out = []
    for r in picked:
        prompt, nt = run.requests[r]
        seq = run.retired[r][1]
        if not np.array_equal(seq[:len(prompt)], prompt) or \
                len(seq) != len(prompt) + nt:
            raise RuntimeError(f"request {r} retired a malformed sequence")
        out.append((prompt, np.asarray(seq[len(prompt):])))
    return out


def reference_logit_rows(ref, weights, cfg, seqs, prec, device):
    """The reference's hidden rows at the positions that chose each served
    token: (rows (R, D) float32, served tokens (R,))."""
    S = max(len(p) + len(s) for p, s in seqs)
    toks = torch.zeros((len(seqs), S), dtype=torch.long, device=device)
    for b, (p, s) in enumerate(seqs):
        full = np.concatenate([p, s])
        toks[b, :len(full)] = torch.from_numpy(full.astype(np.int64))
    with torch.no_grad():
        h = ref.hidden(weights, toks, cfg, prec)
    rows, served = [], []
    for b, (p, s) in enumerate(seqs):
        rows.append(h[b, len(p) - 1:len(p) - 1 + len(s)])
        served.append(torch.from_numpy(s.astype(np.int64)))
    return torch.cat(rows), torch.cat(served).to(device)


def gaps(ref, weights, cfg, rows, pick, prec) -> torch.Tensor:
    """For each row: the reference's best logit less its logit of the
    token ``pick`` gives (a tensor of token ids, or a function of the
    row block's logits that returns them)."""
    out = []
    with torch.no_grad():
        for i in range(0, rows.shape[0], ROW_BLOCK):
            lg = ref.logits(weights, rows[i:i + ROW_BLOCK], cfg, prec)
            tok = pick(i, lg) if callable(pick) else pick[i:i + ROW_BLOCK]
            out.append(lg.amax(-1) - lg.gather(-1, tok[:, None])[:, 0])
    return torch.cat(out)


def logit_gap(run, weights, device) -> dict:
    """The widest gap of the served tokens of the sampled requests."""
    no_tf32()
    spec = run.spec
    picked = sample(run, spec.traffic["sample_tokens"])
    if not picked:
        return {"value": None, "requests": 0, "tokens": 0}
    seqs = sequences(run, picked)
    ref, cfg = spec.reference(), spec.model
    prec = PRECISIONS["float32"]()
    rows, served = reference_logit_rows(ref, weights, cfg, seqs, prec, device)
    g = gaps(ref, weights, cfg, rows, served, prec)
    per = g.split([len(s) for _, s in seqs])
    return {"value": float(g.max()), "requests": len(picked),
            "tokens": int(g.numel()),
            "per_request": {r: float(p.max()) for r, p in zip(picked, per)}}


def control_gap(run, weights, device) -> dict:
    """The control: the reference in fp8 put in the program's place.  At
    the same positions of the same sampled sequences, the token the fp8
    reference puts first, and its gap in the float32 reference."""
    no_tf32()
    spec = run.spec
    picked = sample(run, spec.traffic["sample_tokens"])
    seqs = sequences(run, picked)
    ref, cfg = spec.reference(), spec.model
    f32, low = PRECISIONS["float32"](), PRECISIONS["fp8"]()
    rows, served = reference_logit_rows(ref, weights, cfg, seqs, f32, device)
    rows_low, _ = reference_logit_rows(ref, weights, cfg, seqs, low, device)

    def low_pick(i, _):
        lg = ref.logits(weights, rows_low[i:i + ROW_BLOCK], cfg, low)
        return lg.argmax(-1)

    program = gaps(ref, weights, cfg, rows, served, f32)
    control = gaps(ref, weights, cfg, rows, low_pick, f32)
    return {"program": float(program.max()), "control": float(control.max()),
            "requests": len(picked), "tokens": int(program.numel())}


def decisions_differing(run) -> dict:
    """Decisions of the timed call that differ from the plain HEFT_RT."""
    speeds = run.spec.cell["speeds"]
    av = run.avail0.astype(np.float32)
    bad, first = 0, None
    for k, (kind, reqs, got, _) in enumerate(run.decisions):
        plens = [len(run.requests[r][0]) for r in reqs]
        nts = [run.requests[r][1] for r in reqs]
        want = heft_rt.mapping_event(
            heft_rt.exec_estimates(plens, nts, speeds), av)
        av = want[4]
        same = all(np.array_equal(np.asarray(g).view(np.int32),
                                  np.asarray(w).view(np.int32))
                   for g, w in zip(got, want))
        if not same:
            bad += 1
            if first is None:
                first = {"event": k, "kind": kind, "got": [
                    np.asarray(g).tolist() for g in got], "want": [
                    np.asarray(w).tolist() for w in want]}
    return {"value": bad, "decisions": len(run.decisions), "first": first}
