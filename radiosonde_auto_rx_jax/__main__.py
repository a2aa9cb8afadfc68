"""``python -m radiosonde_auto_rx_jax`` — run the station CLI."""

import sys

from radiosonde_auto_rx_jax.station.main import main

sys.exit(main())
