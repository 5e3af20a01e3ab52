"""Command-line entry points.

  python -m gaussctrl_tpu_torch.cli.train         the whole edit of a scene
                                                  (`ns-train gaussctrl`)
  python -m gaussctrl_tpu_torch.cli.splat_train   pre-training of a scene
                                                  from its point cloud
                                                  (`ns-train splatfacto`)
  python -m gaussctrl_tpu_torch.cli.eval          CLIP metrics of an edit

Dotted flags mirror the reference CLI (`--pipeline.edit_prompt ...`).
"""
