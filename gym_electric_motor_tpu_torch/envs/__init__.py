from .catalog import (DC_ENV_IDS, DFIM_ENV_IDS, EESM_ENV_IDS, ENV_IDS, SCIM_ENV_IDS,
                      SRM_ENV_IDS, SYNC_ENV_IDS, make, make_functional)

__all__ = ["DC_ENV_IDS", "DFIM_ENV_IDS", "EESM_ENV_IDS", "ENV_IDS", "SCIM_ENV_IDS",
           "SRM_ENV_IDS", "SYNC_ENV_IDS", "make", "make_functional"]
