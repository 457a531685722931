"""Task registry: the 7 GenPercept checkpoints and their decode/postproc rules.

Mirrors the reference's per-mode behavior (`genpercept_pipeline.py:507-526`
channel-mean set; `run.py:190-196` mode choices; DPT-head variants per
`run.py:283-312` checkpoint sniffing).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    channel_mean: bool  # decode: average the 3 decoder channels to 1
    color_map: str | None  # colorized preview (depth/disparity only)
    dpt_head: str | None  # None | "general" | "identity"
    save_16bit: bool  # run.py:451-456 — depth saves 16-bit png


TASKS = {
    "depth": TaskSpec("depth", channel_mean=True, color_map="Spectral",
                      dpt_head=None, save_16bit=True),
    "normal": TaskSpec("normal", channel_mean=False, color_map=None,
                       dpt_head=None, save_16bit=False),
    "dis": TaskSpec("dis", channel_mean=True, color_map=None,
                    dpt_head=None, save_16bit=False),
    "matting": TaskSpec("matting", channel_mean=True, color_map=None,
                        dpt_head=None, save_16bit=False),
    "seg": TaskSpec("seg", channel_mean=False, color_map=None,
                    dpt_head=None, save_16bit=False),
    "disparity": TaskSpec("disparity", channel_mean=True, color_map="Spectral",
                          dpt_head=None, save_16bit=False),
    "disparity_dpt_head": TaskSpec("disparity_dpt_head", channel_mean=True,
                                   color_map="Spectral", dpt_head="identity",
                                   save_16bit=False),
}
