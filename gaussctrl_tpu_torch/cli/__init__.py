"""Command-line entry points.

  python -m gaussctrl_tpu_torch.cli.train         the whole edit of a scene
                                                  (`ns-train gaussctrl`)
  python -m gaussctrl_tpu_torch.cli.splat_train   pre-training of a scene
                                                  from its point cloud
                                                  (`ns-train splatfacto`)
  python -m gaussctrl_tpu_torch.cli.render        dataset views, camera
                                                  paths (perspective,
                                                  equirectangular, ODS,
                                                  VR180), trajectories
                                                  (`ns-gaussctrl-render`)
  python -m gaussctrl_tpu_torch.cli.export        a scene as a 3DGS or
                                                  point-cloud PLY
                                                  (`ns-export`)
  python -m gaussctrl_tpu_torch.cli.viewer        the browser orbit viewer
                                                  (`ns-viewer`)
  python -m gaussctrl_tpu_torch.cli.eval          CLIP metrics of an edit
  python -m gaussctrl_tpu_torch.cli.certify       the real-weight battery

Every entry point runs on the card unless `--device cpu`. Dotted flags
mirror the reference CLI (`--pipeline.edit_prompt ...`).
"""
