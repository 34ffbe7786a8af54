"""Distribution layer of the port.  Only the host-side straggler monitor
is here yet; sharding, elastic re-sharding and gradient compression
come with the distributed slice."""
