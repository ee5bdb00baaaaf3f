"""KITTI odometry runner (reference: examples/run_dso_kitti.cc).

Usage:
  python -m ldso_tpu_torch.examples.run_dso_kitti files=<sequence_dir> \
      calib=camera.txt [preset=0] [mode=1] [loopclosing=1] \
      [pipeline=strict|lookahead|async] [output=results.txt]
"""

import sys

from ldso_tpu_torch.examples.run_common import main

if __name__ == "__main__":
    # KITTI has no photometric calibration: mode=1 unless given
    main(sys.argv[1:], dataset_type="kitti", kitti_output=True,
         default_mode=1)
