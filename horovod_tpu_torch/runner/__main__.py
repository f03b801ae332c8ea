import sys

from horovod_tpu_torch.runner.launch import main

sys.exit(main())
