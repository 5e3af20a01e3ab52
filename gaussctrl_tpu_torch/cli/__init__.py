"""Command-line entry points.

  python -m gaussctrl_tpu_torch.cli.train   the whole edit of a scene
                                            (`ns-train gaussctrl`)

Dotted flags mirror the reference CLI (`--pipeline.edit_prompt ...`).
"""
