"""EuRoC MAV runner, cam0 (reference: examples/run_dso_euroc.cc).

Usage:
  python -m ldso_tpu_torch.examples.run_dso_euroc files=<mav0/cam0> \
      calib=camera.txt [preset=0] [loopclosing=1] \
      [pipeline=strict|lookahead|async] [output=results.txt]
"""

import sys

from ldso_tpu_torch.examples.run_common import main

if __name__ == "__main__":
    main(sys.argv[1:], dataset_type="euroc")
