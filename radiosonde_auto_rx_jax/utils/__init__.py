"""Host-side utilities: geometry, serial handling, sonde-specific helpers."""

from radiosonde_auto_rx_jax.utils.geometry import (
    position_info, GenericTrack, time_to_landing)
from radiosonde_auto_rx_jax.utils.sonde_specific import (
    fix_datetime, imet_unique_id, decode_dfm_subtype)
from radiosonde_auto_rx_jax.utils.serial import (
    strip_sonde_serial, short_type_lookup, generate_aprs_id)
