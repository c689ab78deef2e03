"""Host utilities, copied from the reference package: enums, option
registry and stage timing."""
