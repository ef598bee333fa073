"""Pictures of the port: the demo's skeleton plots, feature-map tiles and
video export."""
