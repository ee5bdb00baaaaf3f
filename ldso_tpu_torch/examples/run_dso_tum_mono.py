"""TUM monoVO runner (reference: examples/run_dso_tum_mono.cc).

Usage:
  python -m ldso_tpu_torch.examples.run_dso_tum_mono \
      files=<sequence.zip|dir> calib=camera.txt gamma=pcalib.txt \
      vignette=vignette.png [vocab=orbvoc.txt] [preset=0] [loopclosing=1] \
      [pipeline=strict|lookahead|async] [output=results.txt]

TUM-mono ships its frames as JPEG; decoding them needs PIL.
"""

import sys

from ldso_tpu_torch.examples.run_common import main

if __name__ == "__main__":
    main(sys.argv[1:], dataset_type="tum")
